"""Launch tooling of the LM path: the production meshes (``mesh``) and the
dry run (``dryrun``). The reference's ``launch/devices.py`` only sets
XLA's host-platform device count; PyTorch has no such flag (ranks are
processes), so it has no counterpart here."""
