"""``python -m distributed_learning_tpu_torch`` — the training CLI."""

from distributed_learning_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
