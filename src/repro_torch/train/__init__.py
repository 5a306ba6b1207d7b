"""``repro_torch.train`` — the training plane (port of ``repro.train``):
atomic, checksummed checkpoints (``checkpoint``), the retry / straggler
policies (``fault_tolerance``), learning-rate schedules (``schedule``),
optimizers on trees of tensors (``optimizer``), gradient codecs with
error feedback (``compression``) and the training loop (``trainer``)."""
