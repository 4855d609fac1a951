"""Video Swin-B (Liu et al., "Video Swin Transformer", CVPR 2022;
arXiv:2106.13230) in plain PyTorch, float32: the published
``SwinTransformer3D`` (``github.com/SwinTransformer/Video-Swin-Transformer``,
``swin_base_patch244_window877_kinetics400_1k.py``: patch (2,4,4),
embedding 128, depths (2,2,18,2), heads (4,8,16,32), window (8,7,7), MLP
ratio 4, qkv bias, ``patch_norm``) with mmaction's ``I3DHead`` (average over
T, H, W, then ``fc_cls``), written as the published code computes:
``get_window_size``, ``compute_mask`` with its three slices an axis and
``masked_fill(-100)``, ``relative_position_index`` from ``meshgrid``,
``torch.roll``, ``window_partition``/``window_reverse``, ``q * scale`` then
``q @ kᵀ``, the bias sliced ``[:N, :N]``, zero padding after ``norm1``
(padded tokens are keys, unmasked). A model takes a normalized-domain clip
(B, 3, T, H, W), the artifact protocol's, and returns its logits.

Departures from the published code, in names only: the backbone's modules
sit at the top (no ``backbone.``), the head is ``fc`` (not
``cls_head.fc_cls``), and the module holds no ``relative_position_index``
buffer (it is made at each forward), so that its state dict is the port's
and one seeded draw fills both. Dropout and drop-path are the identity at
evaluation and are left out. ``tiny`` gives the port's width-32 test
variant (window (4,3,3), two blocks a stage, 10 classes)."""

from __future__ import annotations

from functools import reduce
from operator import mul

import torch
import torch.nn as nn
import torch.nn.functional as F


def window_partition(x, window_size):
    B, D, H, W, C = x.shape
    x = x.view(B, D // window_size[0], window_size[0], H // window_size[1], window_size[1],
               W // window_size[2], window_size[2], C)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).contiguous().view(-1, reduce(mul, window_size), C)


def window_reverse(windows, window_size, B, D, H, W):
    x = windows.view(B, D // window_size[0], H // window_size[1], W // window_size[2],
                     window_size[0], window_size[1], window_size[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).contiguous().view(B, D, H, W, -1)


def get_window_size(x_size, window_size, shift_size=None):
    use_window_size = list(window_size)
    if shift_size is not None:
        use_shift_size = list(shift_size)
    for i in range(len(x_size)):
        if x_size[i] <= window_size[i]:
            use_window_size[i] = x_size[i]
            if shift_size is not None:
                use_shift_size[i] = 0
    if shift_size is None:
        return tuple(use_window_size)
    return tuple(use_window_size), tuple(use_shift_size)


def compute_mask(D, H, W, window_size, shift_size, device):
    img_mask = torch.zeros((1, D, H, W, 1), device=device)
    cnt = 0
    for d in (slice(-window_size[0]), slice(-window_size[0], -shift_size[0]),
              slice(-shift_size[0], None)):
        for h in (slice(-window_size[1]), slice(-window_size[1], -shift_size[1]),
                  slice(-shift_size[1], None)):
            for w in (slice(-window_size[2]), slice(-window_size[2], -shift_size[2]),
                      slice(-shift_size[2], None)):
                img_mask[:, d, h, w, :] = cnt
                cnt += 1
    mask_windows = window_partition(img_mask, window_size).squeeze(-1)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, float(-100.0)).masked_fill(attn_mask == 0,
                                                                           float(0.0))


def relative_position_index(window_size, device):
    coords = torch.stack(torch.meshgrid(torch.arange(window_size[0]),
                                        torch.arange(window_size[1]),
                                        torch.arange(window_size[2]), indexing="ij"))
    coords_flatten = torch.flatten(coords, 1)
    relative_coords = coords_flatten[:, :, None] - coords_flatten[:, None, :]
    relative_coords = relative_coords.permute(1, 2, 0).contiguous()
    relative_coords[:, :, 0] += window_size[0] - 1
    relative_coords[:, :, 1] += window_size[1] - 1
    relative_coords[:, :, 2] += window_size[2] - 1
    relative_coords[:, :, 0] *= (2 * window_size[1] - 1) * (2 * window_size[2] - 1)
    relative_coords[:, :, 1] *= (2 * window_size[2] - 1)
    return relative_coords.sum(-1).to(device)


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class WindowAttention3D(nn.Module):
    def __init__(self, dim, window_size, num_heads):
        super().__init__()
        self.window_size = window_size
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(torch.zeros(
            (2 * window_size[0] - 1) * (2 * window_size[1] - 1) * (2 * window_size[2] - 1),
            num_heads))
        self.qkv = nn.Linear(dim, dim * 3, bias=True)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, mask=None):
        B_, N, C = x.shape
        qkv = self.qkv(x).reshape(B_, N, 3, self.num_heads, C // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        q = q * self.scale
        attn = q @ k.transpose(-2, -1)
        index = relative_position_index(self.window_size, x.device)
        bias = self.relative_position_bias_table[index[:N, :N].reshape(-1)].reshape(N, N, -1)
        attn = attn + bias.permute(2, 0, 1).contiguous().unsqueeze(0)
        if mask is not None:
            nW = mask.shape[0]
            attn = attn.view(B_ // nW, nW, self.num_heads, N, N) + mask.unsqueeze(1).unsqueeze(0)
            attn = attn.view(-1, self.num_heads, N, N)
        attn = attn.softmax(dim=-1)
        x = (attn @ v).transpose(1, 2).reshape(B_, N, C)
        return self.proj(x)


class SwinTransformerBlock3D(nn.Module):
    def __init__(self, dim, num_heads, window_size, shift_size):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention3D(dim, window_size, num_heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, dim * 4)

    def forward_part1(self, x, mask_matrix):
        B, D, H, W, C = x.shape
        window_size, shift_size = get_window_size((D, H, W), self.window_size, self.shift_size)
        x = self.norm1(x)
        pad_d1 = (window_size[0] - D % window_size[0]) % window_size[0]
        pad_b = (window_size[1] - H % window_size[1]) % window_size[1]
        pad_r = (window_size[2] - W % window_size[2]) % window_size[2]
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b, 0, pad_d1))
        _, Dp, Hp, Wp, _ = x.shape
        if any(i > 0 for i in shift_size):
            shifted_x = torch.roll(x, shifts=(-shift_size[0], -shift_size[1], -shift_size[2]),
                                   dims=(1, 2, 3))
            attn_mask = mask_matrix
        else:
            shifted_x = x
            attn_mask = None
        x_windows = window_partition(shifted_x, window_size)
        attn_windows = self.attn(x_windows, mask=attn_mask)
        attn_windows = attn_windows.view(-1, *(window_size + (C,)))
        shifted_x = window_reverse(attn_windows, window_size, B, Dp, Hp, Wp)
        if any(i > 0 for i in shift_size):
            x = torch.roll(shifted_x, shifts=(shift_size[0], shift_size[1], shift_size[2]),
                           dims=(1, 2, 3))
        else:
            x = shifted_x
        if pad_d1 > 0 or pad_r > 0 or pad_b > 0:
            x = x[:, :D, :H, :W, :].contiguous()
        return x

    def forward(self, x, mask_matrix):
        x = x + self.forward_part1(x, mask_matrix)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(4 * dim)

    def forward(self, x):
        B, D, H, W, C = x.shape
        if (H % 2 == 1) or (W % 2 == 1):
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x0 = x[:, :, 0::2, 0::2, :]
        x1 = x[:, :, 1::2, 0::2, :]
        x2 = x[:, :, 0::2, 1::2, :]
        x3 = x[:, :, 1::2, 1::2, :]
        return self.reduction(self.norm(torch.cat([x0, x1, x2, x3], -1)))


class BasicLayer(nn.Module):
    def __init__(self, dim, depth, num_heads, window_size, downsample):
        super().__init__()
        self.window_size = window_size
        self.shift_size = tuple(i // 2 for i in window_size)
        self.blocks = nn.ModuleList([
            SwinTransformerBlock3D(dim, num_heads, window_size,
                                   (0, 0, 0) if (i % 2 == 0) else self.shift_size)
            for i in range(depth)])
        self.downsample = PatchMerging(dim) if downsample else None

    def forward(self, x):
        """→ (the blocks' output, the merged output), (B, C, T, H, W) each."""
        B, C, D, H, W = x.shape
        window_size, shift_size = get_window_size((D, H, W), self.window_size, self.shift_size)
        x = x.permute(0, 2, 3, 4, 1)
        Dp = -(-D // window_size[0]) * window_size[0]
        Hp = -(-H // window_size[1]) * window_size[1]
        Wp = -(-W // window_size[2]) * window_size[2]
        attn_mask = compute_mask(Dp, Hp, Wp, window_size, shift_size, x.device)
        for blk in self.blocks:
            x = blk(x, attn_mask)
        x = x.view(B, D, H, W, -1)
        out = x
        if self.downsample is not None:
            x = self.downsample(x)
        return out.permute(0, 4, 1, 2, 3), x.permute(0, 4, 1, 2, 3)


class PatchEmbed3D(nn.Module):
    def __init__(self, patch_size, embed_dim):
        super().__init__()
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.proj = nn.Conv3d(3, embed_dim, kernel_size=patch_size, stride=patch_size)
        self.norm = nn.LayerNorm(embed_dim)

    def forward(self, x):
        _, _, D, H, W = x.size()
        if W % self.patch_size[2] != 0:
            x = F.pad(x, (0, self.patch_size[2] - W % self.patch_size[2]))
        if H % self.patch_size[1] != 0:
            x = F.pad(x, (0, 0, 0, self.patch_size[1] - H % self.patch_size[1]))
        if D % self.patch_size[0] != 0:
            x = F.pad(x, (0, 0, 0, 0, 0, self.patch_size[0] - D % self.patch_size[0]))
        x = self.proj(x)
        D, Wh, Ww = x.size(2), x.size(3), x.size(4)
        x = self.norm(x.flatten(2).transpose(1, 2))
        return x.transpose(1, 2).view(-1, self.embed_dim, D, Wh, Ww)


class SwinTransformer3D(nn.Module):
    def __init__(self, patch_size=(2, 4, 4), embed_dim=128, depths=(2, 2, 18, 2),
                 num_heads=(4, 8, 16, 32), window_size=(8, 7, 7), num_classes=400):
        super().__init__()
        self.patch_embed = PatchEmbed3D(patch_size, embed_dim)
        self.layers = nn.ModuleList([
            BasicLayer(embed_dim * 2**i, depths[i], num_heads[i], window_size,
                       downsample=i < len(depths) - 1)
            for i in range(len(depths))])
        num_features = embed_dim * 2 ** (len(depths) - 1)
        self.norm = nn.LayerNorm(num_features)
        self.fc = nn.Linear(num_features, num_classes)

    def features(self, x):
        """→ the stage outputs before each merging, (B, C, T, H, W) each."""
        x = self.patch_embed(x)
        out = []
        for layer in self.layers:
            stage, x = layer(x)
            out.append(stage)
        return out

    def forward(self, x):
        x = self.features(x)[-1].permute(0, 2, 3, 4, 1)
        x = self.norm(x).permute(0, 4, 1, 2, 3)
        return self.fc(x.mean(dim=(2, 3, 4)))


def build(name: str = "swin3d_b", tiny: bool = False) -> nn.Module:
    """Swin-B (or its tiny test variant), float32, eval, frozen."""
    if name != "swin3d_b":
        raise ValueError(f"no reference Swin model {name!r}")
    m = (SwinTransformer3D(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8),
                           window_size=(4, 3, 3), num_classes=10) if tiny
         else SwinTransformer3D())
    return m.eval().requires_grad_(False)
