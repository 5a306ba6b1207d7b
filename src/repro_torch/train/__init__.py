"""``repro_torch.train`` — the host-side training plane the streaming
slice needs (port of part of ``repro.train``): atomic, checksummed
checkpoints (``checkpoint``) and the retry / straggler policies
(``fault_tolerance``).  The trainer, optimizer and schedules are queued
in ROADMAP A11b."""
