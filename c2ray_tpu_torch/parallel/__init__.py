"""Parallel layouts over torch.distributed (the port of c2ray_tpu/parallel)."""
