"""PointNet++ (single- and multi-scale grouping, feature propagation) for P-FID / P-IS.

Counterpart of :mod:`pcdiff.evals.pointnet2`, with its grouping semantics, on which P-FID
depends:

- ``query_ball_point``: radius mask, then an index sort, then the first K, with the
  misses padded by the group's first hit;
- deterministic FPS at evaluation (batch element b starts at point b);
- set abstraction: grouped relative coordinates (and features), a shared stack of 1x1
  convolution, batch norm and ReLU, then the max over the neighbourhood.

The classifier taps its features at the fc2 batch norm's output (``256 * width_mult``
wide). Inputs and outputs are channels-last, as the JAX package's.

Parameters and buffers carry the names and layouts of the reference's torch
``state_dict`` (``sa1.mlp_convs.0.weight [out, in, 1, 1]``, ``sa1.mlp_bns.0.running_mean``,
``fc1.weight``, ``bn1.num_batches_tracked``, ...), so ``load_state_dict(strict=True)``
takes a reference checkpoint as it is. Each 1x1 convolution is one matmul over the channel
axis (:class:`Pointwise`): no cuDNN convolution runs, so cuDNN's TF32 default for fp32
convolutions never applies. Batch norm always uses its running statistics: the extractor
only evaluates. :func:`pointnet2_state_from_flax` (and its MSG and FP counterparts) carries
the JAX package's flax variables across.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..geometry.fps import farthest_point_sample
from ..geometry.ops import index_points, square_distance

__all__ = [
    "query_ball_point",
    "sample_and_group",
    "sample_and_group_all",
    "Pointwise",
    "BatchNorm",
    "PointNetSetAbstraction",
    "PointNetSetAbstractionMsg",
    "PointNetFeaturePropagation",
    "PointNet2ClassifierSSG",
    "import_pointnet2_torch_state",
    "pointnet2_state_from_flax",
    "sa_msg_state_from_flax",
    "fp_state_from_flax",
]


def query_ball_point(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor) -> torch.Tensor:
    """Indices [B, S, nsample] (int64) of up to ``nsample`` points of ``xyz`` [B, N, 3]
    within ``radius`` of each query of ``new_xyz`` [B, S, 3], in index order; the misses
    are padded with each group's first in-radius index (the reference's semantics)."""
    n = xyz.shape[1]
    sqrdists = square_distance(new_xyz, xyz)  # [B, S, N]
    base = torch.arange(n, device=xyz.device).expand(sqrdists.shape)
    group_idx = torch.where(sqrdists > radius ** 2, n, base)
    group_idx = group_idx.sort(dim=-1).values[:, :, :nsample]
    group_first = group_idx[:, :, :1].expand_as(group_idx)
    return torch.where(group_idx == n, group_first, group_idx)


def sample_and_group(npoint: int, radius: float, nsample: int, xyz: torch.Tensor,
                     points: Optional[torch.Tensor], deterministic: bool = True,
                     generator: Optional[torch.Generator] = None, row_offset: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FPS centroids [B, npoint, 3] and their ball-query neighbourhoods [B, npoint,
    nsample, 3 (+ D)]: coordinates relative to the centroid, then ``points``' features.
    ``row_offset``: the rows' place in the whole batch, where FPS starts."""
    fps_idx = farthest_point_sample(xyz, npoint, deterministic=deterministic,
                                    generator=generator, row_offset=row_offset)
    new_xyz = index_points(xyz, fps_idx)  # [B, S, 3]
    idx = query_ball_point(radius, nsample, xyz, new_xyz)
    grouped_xyz_norm = index_points(xyz, idx) - new_xyz[:, :, None, :]
    if points is None:
        return new_xyz, grouped_xyz_norm
    return new_xyz, torch.cat([grouped_xyz_norm, index_points(points, idx)], dim=-1)


def sample_and_group_all(xyz: torch.Tensor, points: Optional[torch.Tensor]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One group holding every point, centred at the origin: ([B, 1, 3] zeros,
    [B, 1, N, 3 (+ D)])."""
    b, _, c = xyz.shape
    new_xyz = xyz.new_zeros(b, 1, c)
    grouped = xyz[:, None]
    if points is not None:
        grouped = torch.cat([grouped, points[:, None]], dim=-1)
    return new_xyz, grouped


class Pointwise(nn.Module):
    """A 1x1 convolution (``kernel_dims`` 2: ``nn.Conv2d``'s ``weight [out, in, 1, 1]``;
    1: ``nn.Conv1d``'s ``[out, in, 1]``) or, with ``kernel_dims`` 0, a linear layer
    (``[out, in]``), applied to the last axis of channels-last input as one matmul."""

    def __init__(self, in_channels: int, out_channels: int, kernel_dims: int = 2,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, *(1,) * kernel_dims, device=device))
        self.bias = nn.Parameter(torch.empty(out_channels, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        # torch's default for convolutions and linear layers: U(+-1 / sqrt(fan_in))
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        for t in (self.weight, self.bias):
            nn.init.uniform_(t, -bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.flatten(1), self.bias)


class BatchNorm(nn.Module):
    """Batch norm of the last axis on its running statistics, with the parameters and
    buffers of ``nn.BatchNorm*d``: ``(x - mean) * (rsqrt(var + eps) * weight) + bias``,
    flax's order."""

    def __init__(self, channels: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(channels, device=device))
        self.bias = nn.Parameter(torch.empty(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        del generator
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean) * scale + self.bias


def _stack(in_channels: int, mlp: Sequence[int], kernel_dims: int, device
           ) -> Tuple[nn.ModuleList, nn.ModuleList]:
    convs, bns = nn.ModuleList(), nn.ModuleList()
    for out in mlp:
        convs.append(Pointwise(in_channels, out, kernel_dims, device))
        bns.append(BatchNorm(out, device=device))
        in_channels = out
    return convs, bns


def _run_stack(h: torch.Tensor, convs: nn.ModuleList, bns: nn.ModuleList) -> torch.Tensor:
    for conv, bn in zip(convs, bns):
        h = torch.relu(bn(conv(h)))
    return h


class PointNetSetAbstraction(nn.Module):
    """Set abstraction: group, then the shared 1x1 convolution / batch norm / ReLU stack,
    then the max over each group. ``in_channel`` counts the 3 relative coordinates."""

    def __init__(self, npoint: Optional[int], radius: Optional[float],
                 nsample: Optional[int], in_channel: int, mlp: Sequence[int],
                 group_all: bool, device=None):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.group_all = group_all
        self.mlp_convs, self.mlp_bns = _stack(in_channel, mlp, 2, device)

    def group(self, xyz: torch.Tensor, points: Optional[torch.Tensor], row_offset: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(new_xyz [B, S, 3], grouped [B, S, K, C_in]); ``row_offset`` as in
        :func:`sample_and_group`."""
        if self.group_all:
            return sample_and_group_all(xyz, points)
        return sample_and_group(self.npoint, self.radius, self.nsample, xyz, points,
                                row_offset=row_offset)

    def pool(self, grouped: torch.Tensor) -> torch.Tensor:
        """The shared stack over [B, S, K, C_in], then the max over K -> [B, S, mlp[-1]]."""
        return _run_stack(grouped, self.mlp_convs, self.mlp_bns).amax(dim=2)

    def forward(self, xyz: torch.Tensor, points: Optional[torch.Tensor], row_offset: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """xyz [B, N, 3], points [B, N, D] or None -> (new_xyz, features [B, S, mlp[-1]])."""
        new_xyz, grouped = self.group(xyz, points, row_offset)
        return new_xyz, self.pool(grouped)


class PointNetSetAbstractionMsg(nn.Module):
    """Multi-scale grouping: one FPS centroid set queried at each radius, each scale with
    its own stack and max, the scales' features concatenated. Grouped inputs are
    [features, relative coordinates] (the reverse of :func:`sample_and_group`'s order), so
    a scale's first convolution takes ``in_channel + 3`` channels."""

    def __init__(self, npoint: int, radius_list: Sequence[float],
                 nsample_list: Sequence[int], in_channel: int,
                 mlp_list: Sequence[Sequence[int]], device=None):
        super().__init__()
        self.npoint = npoint
        self.radius_list, self.nsample_list = list(radius_list), list(nsample_list)
        self.conv_blocks, self.bn_blocks = nn.ModuleList(), nn.ModuleList()
        for mlp in mlp_list:
            convs, bns = _stack(in_channel + 3, mlp, 2, device)
            self.conv_blocks.append(convs)
            self.bn_blocks.append(bns)

    def forward(self, xyz: torch.Tensor, points: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (new_xyz [B, S, 3], features [B, S, sum of each scale's last width])."""
        new_xyz = index_points(xyz, farthest_point_sample(xyz, self.npoint,
                                                          deterministic=True))
        outs = []
        for radius, k, convs, bns in zip(self.radius_list, self.nsample_list,
                                         self.conv_blocks, self.bn_blocks):
            idx = query_ball_point(radius, k, xyz, new_xyz)
            grouped = index_points(xyz, idx) - new_xyz[:, :, None, :]
            if points is not None:
                grouped = torch.cat([index_points(points, idx), grouped], dim=-1)
            outs.append(_run_stack(grouped, convs, bns).amax(dim=2))
        return new_xyz, torch.cat(outs, dim=-1)


class PointNetFeaturePropagation(nn.Module):
    """Inverse-distance interpolation from the 3 nearest sources, then a shared stack of
    1x1 convolutions (``nn.Conv1d``'s layout). ``in_channel`` is D1 + D2."""

    def __init__(self, in_channel: int, mlp: Sequence[int], device=None):
        super().__init__()
        self.mlp_convs, self.mlp_bns = _stack(in_channel, mlp, 1, device)

    def forward(self, xyz1: torch.Tensor, xyz2: torch.Tensor,
                points1: Optional[torch.Tensor], points2: torch.Tensor) -> torch.Tensor:
        """xyz1 [B, N, 3] targets, xyz2 [B, S, 3] sources, points1 [B, N, D1] or None,
        points2 [B, S, D2] -> [B, N, mlp[-1]]."""
        b, n, _ = xyz1.shape
        if xyz2.shape[1] == 1:
            interpolated = points2.expand(b, n, points2.shape[-1])
        else:
            neg, idx = torch.topk(-square_distance(xyz1, xyz2), 3, dim=-1)  # 3 nearest
            dist_recip = 1.0 / (-neg + 1e-8)
            weight = dist_recip / dist_recip.sum(dim=2, keepdim=True)
            interpolated = (index_points(points2, idx) * weight[..., None]).sum(dim=2)
        h = interpolated if points1 is None else torch.cat([points1, interpolated], dim=-1)
        return _run_stack(h, self.mlp_convs, self.mlp_bns)


class PointNet2ClassifierSSG(nn.Module):
    """The PointNet++ single-scale-grouping classifier with a feature tap."""

    def __init__(self, num_class: int = 40, normal_channel: bool = False,
                 width_mult: int = 1, device=None):
        super().__init__()
        w = width_mult
        self.normal_channel = normal_channel
        self.width = 1024 * w
        self.sa1 = PointNetSetAbstraction(512, 0.2, 32, 6 if normal_channel else 3,
                                          (64 * w, 64 * w, 128 * w), False, device)
        self.sa2 = PointNetSetAbstraction(128, 0.4, 64, 128 * w + 3,
                                          (128 * w, 128 * w, 256 * w), False, device)
        self.sa3 = PointNetSetAbstraction(None, None, None, 256 * w + 3,
                                          (256 * w, 512 * w, 1024 * w), True, device)
        self.fc1 = Pointwise(1024 * w, 512 * w, 0, device)
        self.bn1 = BatchNorm(512 * w, device=device)
        self.fc2 = Pointwise(512 * w, 256 * w, 0, device)
        self.bn2 = BatchNorm(256 * w, device=device)
        self.fc3 = Pointwise(256 * w, num_class, 0, device)

    def head(self, l3: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """sa3's features [B, 1, 1024 w] -> (log_probs [B, num_class], fc2 features)."""
        x = torch.relu(self.bn1(self.fc1(l3.reshape(l3.shape[0], self.width))))
        feats = self.bn2(self.fc2(x))
        return F.log_softmax(self.fc3(torch.relu(feats)), dim=-1), feats

    def forward(self, xyz: torch.Tensor, features: bool = False, row_offset: int = 0):
        """xyz [B, N, 3 (+3 normals)] channels-last -> (log_probs, sa3's features
        [B, 1, 1024 w][, fc2 features [B, 256 w]]). ``row_offset``: the rows' place in the
        whole batch (a rank's share of one), where each cloud's FPS starts."""
        norm = xyz[..., 3:] if self.normal_channel else None
        xyz = xyz[..., :3]
        l1_xyz, l1 = self.sa1(xyz, norm, row_offset)
        l2_xyz, l2 = self.sa2(l1_xyz, l1, row_offset)
        _, l3 = self.sa3(l2_xyz, l2)
        log_probs, feats = self.head(l3)
        if features:
            return log_probs, l3, feats
        return log_probs, l3


# ------------------------------------------------------------------- weights

def import_pointnet2_torch_state(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """The reference's PointNet++ ``state_dict`` (a checkpoint's ``model_state_dict``;
    tensors or numpy arrays) as the port's: the same names, floating values as fp32 (as
    the JAX package imports them), ready for ``load_state_dict(strict=True)``."""
    out = {}
    for k, v in state_dict.items():
        t = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
        out[k] = t.detach().cpu().float() if t.is_floating_point() else t.detach().cpu()
    return out


def _weight(kernel) -> np.ndarray:
    """A flax kernel (Conv HWIO ``[1, 1, in, out]``, ``[1, in, out]``; Dense ``[in, out]``)
    in torch's layout (``[out, in, 1, 1]``, ``[out, in, 1]``, ``[out, in]``)."""
    k = np.asarray(kernel)
    return np.ascontiguousarray(np.moveaxis(k, (-1, -2), (0, 1)))


def _layer(sd: dict, conv: str, bn: Optional[str], params: Mapping, stats: Mapping,
           src_conv: str, src_bn: Optional[str]) -> None:
    sd[f"{conv}.weight"] = _weight(params[src_conv]["kernel"])
    sd[f"{conv}.bias"] = np.asarray(params[src_conv]["bias"])
    if bn is not None:
        sd[f"{bn}.weight"] = np.asarray(params[src_bn]["scale"])
        sd[f"{bn}.bias"] = np.asarray(params[src_bn]["bias"])
        sd[f"{bn}.running_mean"] = np.asarray(stats[src_bn]["mean"])
        sd[f"{bn}.running_var"] = np.asarray(stats[src_bn]["var"])
        sd[f"{bn}.num_batches_tracked"] = np.zeros((), np.int64)


def _tensors(sd: dict) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def pointnet2_state_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's classifier variables (``{"params", "batch_stats"}``, numpy or
    arrays) as the port's ``state_dict``: the arrays of
    :func:`pcdiff.evals.pointnet2.export_pointnet2_torch_state`, and each batch norm's
    ``num_batches_tracked`` (0)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict = {}
    for sa in ("sa1", "sa2", "sa3"):
        i = 0
        while f"conv_{i}" in params[sa]:
            _layer(sd, f"{sa}.mlp_convs.{i}", f"{sa}.mlp_bns.{i}", params[sa], stats[sa],
                   f"conv_{i}", f"bn_{i}")
            i += 1
    for fc, bn in (("fc1", "bn1"), ("fc2", "bn2")):
        _layer(sd, fc, bn, params, stats, fc, bn)
    _layer(sd, "fc3", None, params, stats, "fc3", None)
    return _tensors(sd)


def sa_msg_state_from_flax(variables: Mapping, num_scales: int) -> Dict[str, torch.Tensor]:
    """A flax ``PointNetSetAbstractionMsg``'s variables as the port's ``state_dict``
    (``conv_blocks.{i}.{j}``, ``bn_blocks.{i}.{j}``)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict = {}
    for i in range(num_scales):
        j = 0
        while f"conv_{i}_{j}" in params:
            _layer(sd, f"conv_blocks.{i}.{j}", f"bn_blocks.{i}.{j}", params, stats,
                   f"conv_{i}_{j}", f"bn_{i}_{j}")
            j += 1
    return _tensors(sd)


def fp_state_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``PointNetFeaturePropagation``'s variables as the port's ``state_dict``
    (``mlp_convs.{i}`` in ``nn.Conv1d``'s layout, ``mlp_bns.{i}``)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict = {}
    i = 0
    while f"conv_{i}" in params:
        _layer(sd, f"mlp_convs.{i}", f"mlp_bns.{i}", params, stats, f"conv_{i}", f"bn_{i}")
        i += 1
    return _tensors(sd)
