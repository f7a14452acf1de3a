import sys

if __name__ == "__main__":
    from repro_torch.analysis.cli import main
    sys.exit(main())
