"""The parts of the reference's model stack (``repro/models``) that the
learned forecaster runs: RMS norm and parameter inits (``common``), the
depthwise causal conv (``ssm``) and the Griffin recurrent block
(``rglru``, train mode). The LM stack itself is not ported yet."""
