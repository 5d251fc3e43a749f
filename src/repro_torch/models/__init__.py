"""The port's model stack (``repro/models``): norms, MLPs, RoPE and inits
(``common``); grouped-query attention (``attention``); the Mamba-2 block
and SSD (``ssm``); the Griffin recurrent block (``rglru``, for griffin and
the learned forecaster); the ``decoder``, ``gemma3`` and ``griffin``
families' assembly (``transformer``) and the ``Model`` facade (``model``)
that ``runtime/serve_loop.py`` serves."""
