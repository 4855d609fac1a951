"""The MViT cell's q, k and v pooling kernel (``pool_qkv_kernel``, the port's
``csrc/pool_qkv.cu``, one launch a block): its name, by which the metric
``pool_qkv_ms_per_clip.mvit`` finds it in a trace. The name holds neither
``conv`` nor the pooling-attention kernel's name, so that neither the conv
classes of :data:`.trace.CATEGORIES` nor :mod:`.pool_attn`'s readers count
it. A program without the kernel leaves nothing to read."""

KERNEL = "pool_qkv_kernel"
