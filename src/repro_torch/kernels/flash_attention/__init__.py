"""The flash-attention kernel: ``ops.flash_attention`` is the public
wrapper (model layout), ``flash_attention`` the binding (``LAUNCHES``),
``ref`` the plain versions. Nothing is imported here, so
``flash_attention`` names the binding module."""
