"""The serving substrate: an attention + MoE decoder whose router, token
dispatch and sampler run on the sort's kernels."""
