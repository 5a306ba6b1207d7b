"""``repro_torch.train`` — the host-side training plane the streaming
slice needs (port of part of ``repro.train``): atomic, checksummed
checkpoints (``checkpoint``) and the retry / straggler policies
(``fault_tolerance``).  The trainer, optimizer and schedules are queued
with the model zoo's training (ROADMAP A11b, its training half)."""
