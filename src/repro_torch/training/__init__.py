"""repro_torch.training — crash-safe checkpoints and snapshots
(`checkpoint`) and the CSV metric logger (`metrics`).  The reference's
optimizers (`training/optim.py`) belong to token training, not ported
yet (ROADMAP.md §1)."""
