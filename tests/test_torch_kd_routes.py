"""The host side of the one-read KD forward (``kernels/kd_loss.py``): the
cluster route's shape, which the wrapper mirrors from
``csrc/kd_kernels.cu``, and the vmap fold that hands the kernel all
clients' rows in one call.  Pure Python and CPU tensors; the kernels need
the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import pytest
import torch

from repro_torch.kernels import kd_loss as KD


@pytest.mark.parametrize("esize", [4, 2])
def test_cluster_plan_at_the_route_boundaries(esize):
    """One CTA a row up to the C whose s and t fill SLICE_BYTES, two CTAs
    one class later; an LM vocabulary of 32768 takes 4 CTAs in fp32 and 2
    in bf16, each slice of 64 KB (three CTAs an SM)."""
    single = KD.SLICE_BYTES // (2 * esize)
    assert KD.cluster_plan(KD.WARP_MAX_C + 1, esize)[0] == 1
    assert KD.cluster_plan(single, esize) == (1, single,
                                              2 * (single * esize + 16))
    assert KD.cluster_plan(single + 1, esize)[0] == 2
    cl, slice_, smem = KD.cluster_plan(32768, esize)
    assert (cl, slice_ * 2 * esize) == ({4: 4, 2: 2}[esize], KD.SLICE_BYTES)
    assert 3 * smem <= 228 * 1024


@pytest.mark.parametrize("esize", [4, 2])
@pytest.mark.parametrize("n_classes", [1025, 5000, 8193, 32768, 50257,
                                       151936])
def test_cluster_plan_covers_the_row(esize, n_classes):
    """Slices of a multiple of 8 classes (16-byte aligned staging) cover the
    row, every CTA holds some of it, and the shared memory fits."""
    cl, slice_, smem = KD.cluster_plan(n_classes, esize)
    assert cl in (1, 2, 4, 8) and slice_ % 8 == 0
    assert (cl - 1) * slice_ < n_classes <= cl * slice_
    assert smem == 2 * (slice_ * esize + 16) <= KD.MAX_DYN_SMEM


@pytest.mark.parametrize("esize", [4, 2])
def test_max_classes_is_the_largest_planned_row(esize):
    """max_classes is the last C whose plan fits the shared memory a block
    may have; eight classes more (the next slice size) do not fit."""
    top = KD.max_classes(esize)
    assert KD.cluster_plan(top, esize)[2] <= KD.MAX_DYN_SMEM
    assert KD.cluster_plan(top + 8, esize)[2] > KD.MAX_DYN_SMEM
    assert top > 151936          # the largest vocabulary of the repo's LMs


def test_fold_makes_views_and_keeps_one_group_rho():
    """Operands batched at dim 0 fold to views (no copy); an operand batched
    elsewhere moves its batch dim first; an unbatched ρ of one group stays
    (1, C), one group for every row, and one of G groups is expanded to
    K·G."""
    K, b, C = 3, 4, 5
    s = torch.randn(K, b, C)
    t_other = torch.randn(b, K, C)
    labels = torch.randint(0, C, (K, b))
    rho1, rho2 = torch.rand(1, C), torch.rand(2, C)
    fs, ft, fy, fr = KD._fold(K, (0, 1, 0, None), (s, t_other, labels, rho1))
    assert fs.data_ptr() == s.data_ptr() and fs.shape == (K * b, C)
    assert fy.data_ptr() == labels.data_ptr()
    assert torch.equal(ft, t_other.movedim(1, 0).reshape(K * b, C))
    assert fr is rho1
    (fr2,) = KD._fold(K, (None, None, None, None), (s, s, labels, rho2))[3:]
    assert fr2.shape == (K * 2, C) and torch.equal(fr2[2:4], rho2)
