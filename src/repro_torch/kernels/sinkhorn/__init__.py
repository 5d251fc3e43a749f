from repro_torch.kernels.sinkhorn.ops import sinkhorn_iteration  # noqa: F401
