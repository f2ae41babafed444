"""Hand-written CUDA kernels and their wrappers.

Each wrapper counts the launches of its kernel in a module attribute.
`LAUNCH_COUNTERS` lists them all: (the kernel's name, its module under
`vitron_tpu_torch.kernels`, the counter's attribute). The runtime's CUDA
graphs (`runtime/graphs.py`) and `chip_smoke.py` read the counts through it.
"""

LAUNCH_COUNTERS = (
    ("int4_matmul", "int4_matmul", "launches"),
    ("flash_attention", "flash_attention", "launches"),
    ("flash_attention_bwd_kv", "flash_attention", "bwd_kv_launches"),
    ("flash_attention_bwd_q", "flash_attention", "bwd_q_launches"),
    ("geglu_ff", "geglu_ff", "launches"),
    ("group_norm_sums", "group_norm", "launches"),
    ("depthwise_conv2d", "depthwise_conv", "launches"),
    ("temporal_conv_k3", "temporal_conv", "launches"),
    ("frame_attention", "temporal_attention", "launches"),
    ("conv3x3_same", "conv2d", "launches"),
    ("w4a8_matmul", "w4a8_matmul", "launches"),
    ("conv2d_w8a8", "conv2d_w8a8", "launches"),
)
