"""The RG-LRU scan kernels: ``ops.rglru_scan`` is the public wrapper,
``rglru_scan`` the binding (``LAUNCHES``), ``ref`` the plain versions.
Nothing is imported here, so ``rglru_scan`` names the binding module (the
reference's package binds the function over it)."""
