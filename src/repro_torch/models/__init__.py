"""The port's model stack (``repro/models``): norms, MLP, RoPE and inits
(``common``); grouped-query attention (``attention``); the Mamba-2 block
and SSD (``ssm``); the Griffin recurrent block, train mode (``rglru``, for
the learned forecaster); the ``decoder`` family's assembly
(``transformer``) and the ``Model`` facade (``model``) that
``runtime/serve_loop.py`` serves."""
