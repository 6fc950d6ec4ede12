"""repro_torch.training — the optimizers of token training (`optim`,
exported as in the reference), crash-safe checkpoints and snapshots
(`checkpoint`) and the CSV metric logger (`metrics`)."""
from repro_torch.training.optim import make_optimizer  # noqa: F401
