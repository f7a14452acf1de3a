"""Tests of the port that need a CUDA card; each skips without one.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core import tree as T
from repro_torch.data.partition import sort_and_partition
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.federated.simulator import FederatedSimulator, SimConfig
from repro_torch.kernels import fedadc_update as FU
from repro_torch.kernels import ops, ref
from repro_torch.kernels import weighted_reduce as WR


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain(dtype):
    """Each CUDA kernel equals its plain version on the card, bit for bit:
    both round every multiply and add in fp32 on its own, and the reduce
    sums the clients in the same order."""
    need_card()
    g = torch.Generator().manual_seed(0)
    for n in (1, 10, 130, 1290, 100_003):
        x, y, z = (torch.randn(n, generator=g).to("cuda", dtype)
                   for _ in range(3))
        m, d = (torch.randn(n, generator=g).cuda() for _ in range(2))
        assert torch.equal(FU.fused_axpy(x, y, -0.05),
                           ref.fused_axpy(x, y, -0.05))
        assert torch.equal(FU.local_update(x, y, z, 0.05),
                           ref.fedadc_local_update(x, y, z, 0.05))
        for a, b in zip(FU.server_update(x, m, d, 0.2, 0.05),
                        ref.fedadc_server_update(x, m, d, 0.2, 0.05)):
            assert torch.equal(a, b)
        stack = torch.randn(8, n, generator=g).to("cuda", dtype)
        w = torch.rand(8, generator=g).cuda()
        assert torch.equal(WR.weighted_reduce(stack, w),
                           ref.weighted_delta_reduce(stack, w))
    torch.cuda.synchronize()


def update_rel_err(card, cpu, start):
    """‖Δθ_card − Δθ_cpu‖ / ‖Δθ_cpu‖ over the whole model, Δθ = θ − θ_0."""
    num = sum(((a.cpu() - b) ** 2).sum()
              for a, b in zip(T.leaves(card), T.leaves(cpu)))
    den = sum(((b - s) ** 2).sum()
              for b, s in zip(T.leaves(cpu), T.leaves(start)))
    return (num / den).sqrt().item()


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["nesterov", "heavyball"])
def test_round_on_the_card_matches_the_cpu(variant):
    """Two one-step FedADC rounds (the second with momentum) on the card,
    TF32 off, and on the CPU from the same parameters and batches: the
    updates agree within 1e-4 relative.  Each step is one gradient, where
    cuDNN's and oneDNN's fp32 convolutions differ only in summation order
    (~1e-5 relative at most); more local steps amplify that through ReLU
    and max-pool switches, so this check keeps H=1.  The card's rounds
    launch the kernels."""
    need_card()
    x, y, xt, yt = make_image_dataset(400, 50, 10, image_size=16)
    parts = sort_and_partition(y, 10, s=2)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        sims = []
        ops.reset_launch_counts()
        for device in ("cuda", "cpu"):
            s = FederatedSimulator(
                FedConfig(variant=variant, local_steps=1, clients_per_round=3,
                          n_clients=10, eta=0.01),
                SimConfig(batch_size=16, cnn_width=8, seed=3), x, y, xt, yt,
                parts, device=device)
            start = T.tree_map(lambda t: t.cpu().clone(), s.params)
            for _ in range(2):
                s.run_round(*s.next_round_inputs())
            sims.append(s)
        counts = ops.launch_counts()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    step_kernel = "fused_axpy" if variant == "nesterov" else "local_update"
    assert counts[step_kernel] > 0 and counts["weighted_reduce"] > 0
    assert counts["server_update"] > 0
    assert update_rel_err(sims[0].params, sims[1].params, start) <= 1e-4
