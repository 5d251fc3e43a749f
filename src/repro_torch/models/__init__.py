"""The port's model stack (``repro/models``): norms, MLPs, RoPE, inits
and the loss (``common``); grouped-query attention (``attention``), MLA
(``mla``) and MoE (``moe``); the Mamba-2 block and SSD (``ssm``); the
Griffin recurrent block (``rglru``, for griffin and the learned
forecaster); every family's assembly (``transformer``) and the ``Model``
facade (``model``) that ``runtime/serve_loop.py`` serves and
``runtime/train_loop.py`` trains."""
