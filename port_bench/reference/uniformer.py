"""UniFormer-B 32x4 (Li et al., "UniFormer: Unified Transformer for Efficient
Spatiotemporal Representation Learning", ICLR 2022; arXiv:2201.04676) in
plain PyTorch, float32: Sense-X's ``Uniformer`` (``github.com/Sense-X/
UniFormer``, ``video_classification/slowfast/models/uniformer.py``) as
``uniformer_base`` builds it (depths [5, 8, 20, 7], widths [64, 128, 320,
512], head dim 64, MLP ratio 4, qkv bias, ``SPLIT`` and ``STD`` false,
``norm_layer`` LayerNorm ε 1e-6), written as the published code computes:
NCDHW between blocks, ``SpeicalPatchEmbed`` (Conv3d (3,4,4) stride (2,4,4)
padding (1,0,0)) and ``PatchEmbed`` (Conv3d (1,2,2) stride (1,2,2)), each
with its ``nn.LayerNorm`` (ε 1e-5) over flattened tokens; ``CBlock``
(``pos_embed`` depthwise 3³, ``norm1`` BatchNorm3d, ``conv1`` 1×1×1,
``attn`` depthwise 5³, ``conv2`` 1×1×1, ``norm2``, ``CMlp`` of 1×1×1
convs); ``SABlock`` (the same ``pos_embed``, then over the flattened tokens
``Attention`` with the scores materialised, ``(q @ kᵀ) * scale``, softmax,
``@ v``, and ``Mlp``); the head ``norm`` (BatchNorm3d), the mean over
T·H·W, ``head`` (Linear). A model takes a normalized-domain clip (B, 3, T,
H, W), the artifact protocol's, and returns its logits.

Departures from the published code:
  - each BatchNorm3d is its eval-mode per-channel affine, ``x·weight +
    bias``, held as parameters (the benchmark's seeded draw fills parameters
    only); ``build(cfg, batch_norm=True)`` gives the published BatchNorm3d
    with its running statistics instead, the layout of a Sense-X checkpoint;
  - dropout, drop-path, ``pre_logits`` and the ``SPLIT`` and ``STD``
    variants are the identity or absent at evaluation and are left out; the
    forward takes the clip itself, not the published one-pathway list.
Its parameter names are Sense-X's and the port's (the port holds the
1×1×1 convs as linears of the same numbers), so one seeded draw fills both.
:func:`build` takes the benchmark configuration's keys; ``TINY`` is the
port's test variant. A forward sets PyTorch's TF32 flags off (as the
harness does for every reference) before it computes."""

from __future__ import annotations

import torch
import torch.nn as nn

PUBLISHED = {
    "frames": 32, "hw": 224, "classes": 400, "depth": [5, 8, 20, 7],
    "embed_dim": [64, 128, 320, 512], "head_dim": 64, "mlp_ratio": 4.0, "conv_stages": 2,
    "patch_kernel": [3, 4, 4], "patch_stride": [2, 4, 4], "patch_padding": [1, 0, 0],
    "merge_kernel": [1, 2, 2], "dpe_kernel": 3, "local_kernel": 5,
    "layer_norm_eps": 1e-6, "patch_norm_eps": 1e-5, "batch_norm_eps": 1e-5,
}
TINY = dict(PUBLISHED, frames=8, hw=64, classes=10, depth=[1, 1, 2, 1],
            embed_dim=[32, 64, 128, 192])


class AffineBatchNorm3d(nn.Module):
    """An eval-mode BatchNorm3d as ``x·weight + bias`` per channel."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return x * self.weight.view(1, -1, 1, 1, 1) + self.bias.view(1, -1, 1, 1, 1)


def bn_3d(dim: int, cfg: dict, batch_norm: bool) -> nn.Module:
    if batch_norm:
        return nn.BatchNorm3d(dim, eps=cfg["batch_norm_eps"])
    return AffineBatchNorm3d(dim)


def conv_1x1x1(inp, oup):
    return nn.Conv3d(inp, oup, (1, 1, 1), (1, 1, 1), (0, 0, 0))


def depthwise(dim, k):
    return nn.Conv3d(dim, dim, (k, k, k), (1, 1, 1), (k // 2,) * 3, groups=dim)


class CMlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = conv_1x1x1(dim, hidden)
        self.act = nn.GELU()
        self.fc2 = conv_1x1x1(hidden, dim)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CBlock(nn.Module):
    def __init__(self, dim, cfg, batch_norm):
        super().__init__()
        self.pos_embed = depthwise(dim, cfg["dpe_kernel"])
        self.norm1 = bn_3d(dim, cfg, batch_norm)
        self.conv1 = conv_1x1x1(dim, dim)
        self.conv2 = conv_1x1x1(dim, dim)
        self.attn = depthwise(dim, cfg["local_kernel"])
        self.norm2 = bn_3d(dim, cfg, batch_norm)
        self.mlp = CMlp(dim, int(dim * cfg["mlp_ratio"]))

    def forward(self, x):
        x = x + self.pos_embed(x)
        x = x + self.conv2(self.attn(self.conv1(self.norm1(x))))
        x = x + self.mlp(self.norm2(x))
        return x


class Attention(nn.Module):
    def __init__(self, dim, num_heads, qkv_bias=True):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.scale = head_dim ** -0.5
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, C // self.num_heads)
        qkv = qkv.permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q @ k.transpose(-2, -1)) * self.scale
        attn = attn.softmax(dim=-1)
        x = (attn @ v).transpose(1, 2).reshape(B, N, C)
        return self.proj(x)


class SABlock(nn.Module):
    def __init__(self, dim, cfg):
        super().__init__()
        eps = cfg["layer_norm_eps"]
        self.pos_embed = depthwise(dim, cfg["dpe_kernel"])
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, dim // cfg["head_dim"])
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, int(dim * cfg["mlp_ratio"]))

    def forward(self, x):
        x = x + self.pos_embed(x)
        B, C, T, H, W = x.shape
        x = x.flatten(2).transpose(1, 2)
        x = x + self.attn(self.norm1(x))
        x = x + self.mlp(self.norm2(x))
        return x.transpose(1, 2).reshape(B, C, T, H, W)


class PatchEmbed(nn.Module):
    """``SpeicalPatchEmbed`` (``first``) or ``PatchEmbed``: the conv, then
    the LayerNorm over flattened tokens, back to NCDHW."""

    def __init__(self, in_chans, embed_dim, cfg, first):
        super().__init__()
        self.norm = nn.LayerNorm(embed_dim, eps=cfg["patch_norm_eps"])
        if first:
            self.proj = nn.Conv3d(in_chans, embed_dim, tuple(cfg["patch_kernel"]),
                                  tuple(cfg["patch_stride"]), tuple(cfg["patch_padding"]))
        else:
            k = tuple(cfg["merge_kernel"])
            self.proj = nn.Conv3d(in_chans, embed_dim, k, k, (0, 0, 0))

    def forward(self, x):
        x = self.proj(x)
        B, C, T, H, W = x.shape
        x = x.flatten(2).transpose(1, 2)
        x = self.norm(x)
        return x.reshape(B, T, H, W, -1).permute(0, 4, 1, 2, 3).contiguous()


class Uniformer(nn.Module):
    def __init__(self, cfg, batch_norm=False):
        super().__init__()
        dims = cfg["embed_dim"]
        self.stages = len(dims)
        for s in range(self.stages):
            setattr(self, f"patch_embed{s + 1}",
                    PatchEmbed(dims[s - 1] if s else 3, dims[s], cfg, first=s == 0))
            blocks = [CBlock(dims[s], cfg, batch_norm) if s < cfg["conv_stages"]
                      else SABlock(dims[s], cfg) for _ in range(cfg["depth"][s])]
            setattr(self, f"blocks{s + 1}", nn.ModuleList(blocks))
        self.norm = bn_3d(dims[-1], cfg, batch_norm)
        self.head = nn.Linear(dims[-1], cfg["classes"])

    def features(self, x):
        """The output of each stage's last block, NCDHW."""
        out = []
        for s in range(self.stages):
            x = getattr(self, f"patch_embed{s + 1}")(x)
            for blk in getattr(self, f"blocks{s + 1}"):
                x = blk(x)
            out.append(x)
        return out

    def forward(self, x):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        x = self.norm(self.features(x)[-1])
        x = x.flatten(2).mean(-1)
        return self.head(x)


def build(cfg: dict, batch_norm: bool = False) -> nn.Module:
    """The model of the configuration's keys, in eval mode."""
    return Uniformer(cfg, batch_norm).eval()
