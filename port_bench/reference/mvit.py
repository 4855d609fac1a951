"""MViTv2-B 32x3 (Li et al., "MViTv2: Improved Multiscale Vision Transformers
for Classification and Detection", CVPR 2022; arXiv:2112.01526) in plain
PyTorch, float32: PySlowFast's ``MViT`` (``github.com/facebookresearch/
SlowFast``, ``slowfast/models/video_model_builder.py`` and
``slowfast/models/attention.py``) under ``configs/Kinetics/
MVITv2_B_32x3.yaml`` (depth 24, embedding 96, one head, ``DIM_MUL`` and
``HEAD_MUL`` [[2, 2.0], [5, 2.0], [21, 2.0]], patch (3,7,7) stride (2,4,4)
padding (1,3,3), ``POOL_KVQ_KERNEL`` (3,3,3), ``POOL_KV_STRIDE_ADAPTIVE``
(1,8,8), ``POOL_Q_STRIDE`` (1,2,2) at blocks 2, 5 and 21 and (1,1,1) at the
others, ``MODE: conv``, ``REL_POS_SPATIAL``, ``REL_POS_TEMPORAL``,
``RESIDUAL_POOLING``, ``DIM_MUL_IN_ATT``, ``CLS_EMBED_ON``, no absolute
position embedding, MLP ratio 4, qkv bias, LayerNorm ε 1e-6) with its
``TransformerBasicHead``, written as the published code computes:
``round_width``, ``_prepare_mvit_configs``, ``attention_pool``,
``cal_rel_pos_spatial`` with its view-and-broadcast adds,
``cal_rel_pos_temporal`` with its permutes and matmul, ``get_rel_pos``,
scores materialised, ``x[:, :, 1:, :] += q[:, :, 1:, :]``, the skip's
``MaxPool3d``. A model takes a normalized-domain clip (B, 3, T, H, W), the
artifact protocol's, and returns its logits.

Departures from the published code:
  - the head returns the Linear's output: the published head applies a
    softmax at test time, which leaves the argmax as it is;
  - the distance indices are made on the tables' device (the published code
    makes them on the host and indexes the tables with them), and the width
    multipliers on the host whatever the default device, so that the model
    also builds and runs on the meta device;
  - dropout, drop-path and the detection branch are the identity or absent
    at evaluation and are left out; the config's other options take only the
    values above.
Its parameter names are PySlowFast's and the port's, so one seeded draw fills
both. :func:`build` takes the benchmark configuration's keys (the port's
``models/mvit.py`` spells the same settings); ``TINY`` is the port's test
variant."""

from __future__ import annotations

import numpy
import torch
import torch.nn as nn
import torch.nn.functional as F

PUBLISHED = {
    "frames": 32, "hw": 224, "classes": 400, "depth": 24, "embed_dim": 96, "num_heads": 1,
    "dim_mul": [[2, 2.0], [5, 2.0], [21, 2.0]], "head_mul": [[2, 2.0], [5, 2.0], [21, 2.0]],
    "patch_kernel": [3, 7, 7], "patch_stride": [2, 4, 4], "patch_padding": [1, 3, 3],
    "pool_kvq_kernel": [3, 3, 3], "pool_kv_stride_adaptive": [1, 8, 8],
    "pool_q_stride": [[i, 1, 2, 2] if i in (2, 5, 21) else [i, 1, 1, 1] for i in range(24)],
    "mlp_ratio": 4.0, "layer_norm_eps": 1e-6,
}
TINY = dict(PUBLISHED, frames=8, hw=32, classes=10, depth=5,
            dim_mul=[[1, 2.0], [3, 2.0], [4, 2.0]], head_mul=[[1, 2.0], [3, 2.0], [4, 2.0]],
            pool_kv_stride_adaptive=[1, 2, 2],
            pool_q_stride=[[i, 1, 2, 2] if i in (1, 3, 4) else [i, 1, 1, 1] for i in range(5)])


def round_width(width, multiplier, min_width=1, divisor=1):
    if not multiplier:
        return width
    width *= multiplier
    min_width = min_width or divisor
    width_out = max(min_width, int(width + divisor / 2) // divisor * divisor)
    if width_out < 0.9 * width:
        width_out += divisor
    return int(width_out)


def prepare_mvit_configs(cfg):
    depth = cfg["depth"]
    dim_mul, head_mul = torch.ones(depth + 1, device="cpu"), torch.ones(depth + 1, device="cpu")
    for k in cfg["dim_mul"]:
        dim_mul[k[0]] = k[1]
    for k in cfg["head_mul"]:
        head_mul[k[0]] = k[1]
    pool_q = [[] for _ in range(depth)]
    pool_kv = [[] for _ in range(depth)]
    stride_q = [[] for _ in range(depth)]
    stride_kv = [[] for _ in range(depth)]
    for row in cfg["pool_q_stride"]:
        stride_q[row[0]] = row[1:]
        pool_q[row[0]] = cfg["pool_kvq_kernel"]
    _stride_kv = cfg["pool_kv_stride_adaptive"]
    pool_kv_stride = []
    for i in range(depth):
        if len(stride_q[i]) > 0:
            _stride_kv = [max(_stride_kv[d] // stride_q[i][d], 1) for d in range(len(_stride_kv))]
        pool_kv_stride.append([i] + _stride_kv)
    for row in pool_kv_stride:
        stride_kv[row[0]] = row[1:]
        pool_kv[row[0]] = cfg["pool_kvq_kernel"]
    return dim_mul, head_mul, pool_q, pool_kv, stride_q, stride_kv


def attention_pool(tensor, pool, thw_shape, has_cls_embed=True, norm=None):
    if pool is None:
        return tensor, thw_shape
    tensor_dim = tensor.ndim
    if tensor_dim == 4:
        pass
    elif tensor_dim == 3:
        tensor = tensor.unsqueeze(1)
    else:
        raise NotImplementedError(f"Unsupported input dimension {tensor.shape}")
    if has_cls_embed:
        cls_tok, tensor = tensor[:, :, :1, :], tensor[:, :, 1:, :]
    B, N, L, C = tensor.shape
    T, H, W = thw_shape
    tensor = tensor.reshape(B * N, T, H, W, C).permute(0, 4, 1, 2, 3).contiguous()
    tensor = pool(tensor)
    thw_shape = [tensor.shape[2], tensor.shape[3], tensor.shape[4]]
    L_pooled = tensor.shape[2] * tensor.shape[3] * tensor.shape[4]
    tensor = tensor.reshape(B, N, C, L_pooled).transpose(2, 3)
    if has_cls_embed:
        tensor = torch.cat((cls_tok, tensor), dim=2)
    if norm is not None:
        tensor = norm(tensor)
    if tensor_dim == 3:
        tensor = tensor.squeeze(1)
    return tensor, thw_shape


def get_rel_pos(rel_pos, d):
    if isinstance(d, int):
        ori_d = rel_pos.shape[0]
        if ori_d == d:
            return rel_pos
        new_pos_embed = F.interpolate(rel_pos.reshape(1, ori_d, -1).permute(0, 2, 1), size=d,
                                      mode="linear")
        return new_pos_embed.reshape(-1, d).permute(1, 0)


def cal_rel_pos_spatial(attn, q, k, has_cls_embed, q_shape, k_shape, rel_pos_h, rel_pos_w):
    sp_idx = 1 if has_cls_embed else 0
    q_t, q_h, q_w = q_shape
    k_t, k_h, k_w = k_shape
    dh = int(2 * max(q_h, k_h) - 1)
    dw = int(2 * max(q_w, k_w) - 1)
    device = rel_pos_h.device
    q_h_ratio = max(k_h / q_h, 1.0)
    k_h_ratio = max(q_h / k_h, 1.0)
    dist_h = (torch.arange(q_h, device=device)[:, None] * q_h_ratio
              - torch.arange(k_h, device=device)[None, :] * k_h_ratio)
    dist_h += (k_h - 1) * k_h_ratio
    q_w_ratio = max(k_w / q_w, 1.0)
    k_w_ratio = max(q_w / k_w, 1.0)
    dist_w = (torch.arange(q_w, device=device)[:, None] * q_w_ratio
              - torch.arange(k_w, device=device)[None, :] * k_w_ratio)
    dist_w += (k_w - 1) * k_w_ratio
    rel_pos_h = get_rel_pos(rel_pos_h, dh)
    rel_pos_w = get_rel_pos(rel_pos_w, dw)
    Rh = rel_pos_h[dist_h.long()]
    Rw = rel_pos_w[dist_w.long()]
    B, n_head, q_N, dim = q.shape
    r_q = q[:, :, sp_idx:].reshape(B, n_head, q_t, q_h, q_w, dim)
    rel_h_q = torch.einsum("bythwc,hkc->bythwk", r_q, Rh)
    rel_w_q = torch.einsum("bythwc,wkc->bythwk", r_q, Rw)
    attn[:, :, sp_idx:, sp_idx:] = (
        attn[:, :, sp_idx:, sp_idx:].view(B, -1, q_t, q_h, q_w, k_t, k_h, k_w)
        + rel_h_q[:, :, :, :, :, None, :, None]
        + rel_w_q[:, :, :, :, :, None, None, :]
    ).view(B, -1, q_t * q_h * q_w, k_t * k_h * k_w)
    return attn


def cal_rel_pos_temporal(attn, q, has_cls_embed, q_shape, k_shape, rel_pos_t):
    sp_idx = 1 if has_cls_embed else 0
    q_t, q_h, q_w = q_shape
    k_t, k_h, k_w = k_shape
    dt = int(2 * max(q_t, k_t) - 1)
    rel_pos_t = get_rel_pos(rel_pos_t, dt)
    device = rel_pos_t.device
    q_t_ratio = max(k_t / q_t, 1.0)
    k_t_ratio = max(q_t / k_t, 1.0)
    dist_t = (torch.arange(q_t, device=device)[:, None] * q_t_ratio
              - torch.arange(k_t, device=device)[None, :] * k_t_ratio)
    dist_t += (k_t - 1) * k_t_ratio
    Rt = rel_pos_t[dist_t.long()]
    B, n_head, q_N, dim = q.shape
    r_q = q[:, :, sp_idx:].reshape(B, n_head, q_t, q_h, q_w, dim)
    r_q = r_q.permute(2, 0, 1, 3, 4, 5).reshape(q_t, B * n_head * q_h * q_w, dim)
    rel = torch.matmul(r_q, Rt.transpose(1, 2)).transpose(0, 1)
    rel = rel.view(B, n_head, q_h, q_w, q_t, k_t).permute(0, 1, 4, 2, 3, 5)
    attn[:, :, sp_idx:, sp_idx:] = (
        attn[:, :, sp_idx:, sp_idx:].view(B, -1, q_t, q_h, q_w, k_t, k_h, k_w)
        + rel[:, :, :, :, :, :, None, None]
    ).view(B, -1, q_t * q_h * q_w, k_t * k_h * k_w)
    return attn


class Mlp(nn.Module):
    def __init__(self, in_features, hidden_features, out_features):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(hidden_features, out_features)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class MultiScaleAttention(nn.Module):
    def __init__(self, dim, dim_out, input_size, num_heads, kernel_q, kernel_kv, stride_q,
                 stride_kv, norm_layer, has_cls_embed=True):
        super().__init__()
        self.num_heads = num_heads
        self.dim_out = dim_out
        head_dim = dim_out // num_heads
        self.scale = head_dim ** -0.5
        self.has_cls_embed = has_cls_embed
        padding_q = [int(q // 2) for q in kernel_q]
        padding_kv = [int(kv // 2) for kv in kernel_kv]
        self.qkv = nn.Linear(dim, dim_out * 3, bias=True)
        self.proj = nn.Linear(dim_out, dim_out)
        if numpy.prod(kernel_q) == 1 and numpy.prod(stride_q) == 1:
            kernel_q = ()
        if numpy.prod(kernel_kv) == 1 and numpy.prod(stride_kv) == 1:
            kernel_kv = ()
        dim_conv = dim_out // num_heads
        self.pool_q = (nn.Conv3d(dim_conv, dim_conv, kernel_q, stride=stride_q,
                                 padding=padding_q, groups=dim_conv, bias=False)
                       if len(kernel_q) > 0 else None)
        self.norm_q = norm_layer(dim_conv) if len(kernel_q) > 0 else None
        self.pool_k = (nn.Conv3d(dim_conv, dim_conv, kernel_kv, stride=stride_kv,
                                 padding=padding_kv, groups=dim_conv, bias=False)
                       if len(kernel_kv) > 0 else None)
        self.norm_k = norm_layer(dim_conv) if len(kernel_kv) > 0 else None
        self.pool_v = (nn.Conv3d(dim_conv, dim_conv, kernel_kv, stride=stride_kv,
                                 padding=padding_kv, groups=dim_conv, bias=False)
                       if len(kernel_kv) > 0 else None)
        self.norm_v = norm_layer(dim_conv) if len(kernel_kv) > 0 else None
        assert input_size[1] == input_size[2]
        size = input_size[1]
        q_size = size // stride_q[1] if len(stride_q) > 0 else size
        kv_size = size // stride_kv[1] if len(stride_kv) > 0 else size
        rel_sp_dim = 2 * max(q_size, kv_size) - 1
        self.rel_pos_h = nn.Parameter(torch.zeros(rel_sp_dim, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(rel_sp_dim, head_dim))
        self.rel_pos_t = nn.Parameter(torch.zeros(2 * input_size[0] - 1, head_dim))

    def forward(self, x, thw_shape):
        B, N, _ = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        q, q_shape = attention_pool(q, self.pool_q, thw_shape, has_cls_embed=self.has_cls_embed,
                                    norm=self.norm_q)
        k, k_shape = attention_pool(k, self.pool_k, thw_shape, has_cls_embed=self.has_cls_embed,
                                    norm=self.norm_k)
        v, v_shape = attention_pool(v, self.pool_v, thw_shape, has_cls_embed=self.has_cls_embed,
                                    norm=self.norm_v)
        attn = (q * self.scale) @ k.transpose(-2, -1)
        attn = cal_rel_pos_spatial(attn, q, k, self.has_cls_embed, q_shape, k_shape,
                                   self.rel_pos_h, self.rel_pos_w)
        attn = cal_rel_pos_temporal(attn, q, self.has_cls_embed, q_shape, k_shape,
                                    self.rel_pos_t)
        attn = attn.softmax(dim=-1)
        x = attn @ v
        if self.has_cls_embed:
            x[:, :, 1:, :] += q[:, :, 1:, :]
        else:
            x = x + q
        x = x.transpose(1, 2).reshape(B, -1, self.dim_out)
        x = self.proj(x)
        return x, q_shape


class MultiScaleBlock(nn.Module):
    def __init__(self, dim, dim_out, num_heads, input_size, mlp_ratio, norm_layer, kernel_q,
                 kernel_kv, stride_q, stride_kv, has_cls_embed=True):
        super().__init__()
        self.dim = dim
        self.dim_out = dim_out
        self.norm1 = norm_layer(dim)
        kernel_skip = [s + 1 if s > 1 else s for s in stride_q]
        stride_skip = stride_q
        padding_skip = [int(skip // 2) for skip in kernel_skip]
        att_dim = dim_out
        self.attn = MultiScaleAttention(dim, att_dim, input_size, num_heads, kernel_q, kernel_kv,
                                        stride_q, stride_kv, norm_layer, has_cls_embed)
        self.norm2 = norm_layer(att_dim)
        mlp_hidden_dim = int(att_dim * mlp_ratio)
        self.has_cls_embed = has_cls_embed
        self.mlp = Mlp(att_dim, mlp_hidden_dim, dim_out)
        if dim != dim_out:
            self.proj = nn.Linear(dim, dim_out)
        self.pool_skip = (nn.MaxPool3d(kernel_skip, stride_skip, padding_skip, ceil_mode=False)
                          if len(stride_skip) > 0 and numpy.prod(stride_skip) > 1 else None)

    def forward(self, x, thw_shape):
        x_norm = self.norm1(x)
        x_block, thw_shape_new = self.attn(x_norm, thw_shape)
        if self.dim != self.dim_out:
            x = self.proj(x_norm)
        x_res, _ = attention_pool(x, self.pool_skip, thw_shape, has_cls_embed=self.has_cls_embed)
        x = x_res + x_block
        x_norm = self.norm2(x)
        x_mlp = self.mlp(x_norm)
        x = x + x_mlp
        return x, thw_shape_new


class PatchEmbed(nn.Module):
    def __init__(self, dim_in, dim_out, kernel, stride, padding):
        super().__init__()
        self.proj = nn.Conv3d(dim_in, dim_out, kernel_size=kernel, stride=stride,
                              padding=padding)

    def forward(self, x):
        x = self.proj(x)
        return x.flatten(2).transpose(1, 2), x.shape


class TransformerBasicHead(nn.Module):
    def __init__(self, dim_in, num_classes):
        super().__init__()
        self.projection = nn.Linear(dim_in, num_classes, bias=True)

    def forward(self, x):
        return self.projection(x)


class MViT(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        embed_dim = cfg["embed_dim"]
        num_heads = cfg["num_heads"]
        depth = cfg["depth"]
        norm_layer = lambda d: nn.LayerNorm(d, eps=cfg["layer_norm_eps"])  # noqa: E731
        self.patch_embed = PatchEmbed(3, embed_dim, cfg["patch_kernel"], cfg["patch_stride"],
                                      cfg["patch_padding"])
        sizes = (cfg["frames"], cfg["hw"], cfg["hw"])
        self.patch_dims = [(s + 2 * p - k) // st + 1 for s, k, st, p in zip(
            sizes, cfg["patch_kernel"], cfg["patch_stride"], cfg["patch_padding"])]
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        dim_mul, head_mul, pool_q, pool_kv, stride_q, stride_kv = prepare_mvit_configs(cfg)
        input_size = self.patch_dims
        self.blocks = nn.ModuleList()
        self.stage_ends = [k[0] - 1 for k in sorted(cfg["dim_mul"])] + [depth - 1]
        for i in range(depth):
            num_heads = round_width(num_heads, head_mul[i])
            dim_out = round_width(embed_dim, dim_mul[i],
                                  divisor=round_width(num_heads, head_mul[i]))
            self.blocks.append(MultiScaleBlock(
                dim=embed_dim, dim_out=dim_out, num_heads=num_heads, input_size=input_size,
                mlp_ratio=cfg["mlp_ratio"], norm_layer=norm_layer,
                kernel_q=pool_q[i] if len(pool_q) > i else [],
                kernel_kv=pool_kv[i] if len(pool_kv) > i else [],
                stride_q=stride_q[i] if len(stride_q) > i else [],
                stride_kv=stride_kv[i] if len(stride_kv) > i else []))
            if len(stride_q[i]) > 0:
                input_size = [size // stride for size, stride in zip(input_size, stride_q[i])]
            embed_dim = dim_out
        self.norm = norm_layer(embed_dim)
        self.head = TransformerBasicHead(embed_dim, cfg["classes"])

    def _blocks(self, x):
        """The stem and every block → (the last block's tokens, each
        stage's output as (B, C, T, H, W) without the class token)."""
        x, bcthw = self.patch_embed(x)
        T, H, W = bcthw[-3], bcthw[-2], bcthw[-1]
        B = x.shape[0]
        x = torch.cat((self.cls_token.expand(B, -1, -1), x), dim=1)
        thw = [T, H, W]
        feats = []
        for i, blk in enumerate(self.blocks):
            x, thw = blk(x, thw)
            if i in self.stage_ends:
                feats.append(x[:, 1:].transpose(1, 2).reshape(B, -1, *thw))
        return x, feats

    def features(self, x):
        return self._blocks(x)[1]

    def forward(self, x):
        x = self._blocks(x)[0]
        x = self.norm(x)
        x = x[:, 0]
        return self.head(x)


def build(cfg: dict) -> nn.Module:
    """The model of a configuration's keys (:data:`PUBLISHED`'s), in eval
    mode, float32."""
    return MViT(cfg).eval()

