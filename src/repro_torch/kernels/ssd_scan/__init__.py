"""The Mamba-2 SSD scan kernel: ``ops.ssd_scan`` is the public wrapper,
``ssd_scan`` the binding (``LAUNCHES``), ``ref`` the plain versions.
Nothing is imported here, so ``ssd_scan`` names the binding module."""
