"""ResNet-18 — the ImageNet-1k conv model.

Port of ``lua_mapreduce_tpu/models/resnet.py``: every conv runs
``ops.conv2d`` (im2col → the matmul kernel), the ImageNet stem's 3x3/2
max pool runs ``ops.maxpool2d`` (the pool kernel), the output
``ops.log_softmax`` (the softmax kernel). GroupNorm, relu, the residual
adds, the global average pool (a plain ``mean``: a full-map mean has no
window structure for the pool kernel) and the FC head stay plain torch,
as they stay outside any Pallas kernel in the JAX package.

Normalization is GroupNorm (stateless, batch-size independent), params
a flat name→tensor dict with the JAX model's names, layouts NHWC/HWIO.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from lua_mapreduce_tpu_torch import ops
from lua_mapreduce_tpu_torch.device import resolve_device
from lua_mapreduce_tpu_torch.ops.conv import _pad_hw

Params = Dict[str, torch.Tensor]

IMAGENET_SHAPE = (224, 224, 3)


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    """Architecture knobs. ``imagenet18()`` is the ImageNet ResNet-18;
    ``tiny()`` the same block structure at test scale."""
    input_shape: Tuple[int, int, int] = IMAGENET_SHAPE
    n_classes: int = 1000
    widths: Tuple[int, ...] = (64, 128, 256, 512)
    blocks_per_stage: Tuple[int, ...] = (2, 2, 2, 2)
    imagenet_stem: bool = True      # 7x7/2 conv + 3x3/2 maxpool; else 3x3/1
    norm_groups: int = 32

    @staticmethod
    def imagenet18() -> "ResNetConfig":
        return ResNetConfig()

    @staticmethod
    def cifar18() -> "ResNetConfig":
        """ResNet-18 with the standard CIFAR stem (3x3/1, no maxpool)."""
        return ResNetConfig(input_shape=(32, 32, 3), n_classes=10,
                            imagenet_stem=False)

    @staticmethod
    def tiny() -> "ResNetConfig":
        """Full block structure at test scale (fast on CPU)."""
        return ResNetConfig(input_shape=(16, 16, 3), n_classes=10,
                            widths=(8, 16), blocks_per_stage=(1, 1),
                            imagenet_stem=False, norm_groups=4)


def _block_plan(cfg: ResNetConfig):
    """Yield (name, stride, needs_proj, c_in, c_out) for every residual
    block — the one source of the downsampling/projection topology for
    init, apply and the FLOPs accounting."""
    c_in = cfg.widths[0]
    for s, (c_out, n_blocks) in enumerate(
            zip(cfg.widths, cfg.blocks_per_stage)):
        for b in range(n_blocks):
            stride = 2 if (s > 0 and b == 0) else 1
            yield (f"s{s}b{b}", stride, stride != 1 or c_in != c_out,
                   c_in, c_out)
            c_in = c_out


def _groups(cfg: ResNetConfig, c: int) -> int:
    g = min(cfg.norm_groups, c)
    while c % g:
        g -= 1
    return g


def _conv_init(gen: torch.Generator, k: int, c_in: int, c_out: int
               ) -> torch.Tensor:
    """He-normal HWIO weights (relu networks), f32 on the CPU."""
    std = math.sqrt(2.0 / (k * k * c_in))
    return std * torch.randn((k, k, c_in, c_out), generator=gen)


def init_resnet(seed: Union[int, torch.Generator] = 0,
                cfg: ResNetConfig = ResNetConfig(),
                dtype: torch.dtype = torch.float32,
                device: Optional[Union[str, torch.device]] = None) -> Params:
    """Flat name→tensor params for the full network, on ``device``
    (default ``"cuda"``).

    Names: ``stem_W``, per block ``s<stage>b<block>_{conv1,conv2,proj}_W``
    plus GroupNorm ``*_g``/``*_be`` scale/bias pairs, final ``fc_W/fc_b``.
    Convs feeding a norm carry no bias; norm scales start at 1. Values
    come from a CPU ``torch.Generator``; they are not the JAX package's
    numbers for the same seed.
    """
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    params: Params = {}

    def put(name: str, t: torch.Tensor):
        params[name] = t.to(device=dev, dtype=dtype)

    def norm(name: str, c: int):
        put(f"{name}_g", torch.ones((c,)))
        put(f"{name}_be", torch.zeros((c,)))

    k_stem = 7 if cfg.imagenet_stem else 3
    put("stem_W", _conv_init(gen, k_stem, cfg.input_shape[-1],
                             cfg.widths[0]))
    norm("stem_n", cfg.widths[0])
    for p, _stride, needs_proj, c_in, c_out in _block_plan(cfg):
        put(f"{p}_conv1_W", _conv_init(gen, 3, c_in, c_out))
        norm(f"{p}_n1", c_out)
        put(f"{p}_conv2_W", _conv_init(gen, 3, c_out, c_out))
        norm(f"{p}_n2", c_out)
        if needs_proj:
            put(f"{p}_proj_W", _conv_init(gen, 1, c_in, c_out))
            norm(f"{p}_np", c_out)
    c_in = cfg.widths[-1]
    bound = math.sqrt(6.0 / (c_in + cfg.n_classes))
    put("fc_W", (torch.rand((c_in, cfg.n_classes), generator=gen) * 2 - 1)
        * bound)
    put("fc_b", torch.zeros((cfg.n_classes,)))
    return params


def _group_norm(params: Params, name: str, x: torch.Tensor,
                groups: int) -> torch.Tensor:
    """Mean and biased variance over (H, W, C/G), eps 1e-5, then the
    per-channel scale and bias: ``F.group_norm`` on the NCHW view (one
    fused op each way, statistics in f32, where reductions and
    elementwise ops would take some twenty launches per norm)."""
    y = F.group_norm(x.permute(0, 3, 1, 2).contiguous(), groups,
                     params[f"{name}_g"], params[f"{name}_be"], 1e-5)
    return y.permute(0, 2, 3, 1).contiguous()


def _stem(params: Params, x: torch.Tensor, cfg: ResNetConfig
          ) -> torch.Tensor:
    if cfg.imagenet_stem:
        x = ops.conv2d(x, params["stem_W"], stride=2, padding="SAME")
        x = torch.relu(_group_norm(params, "stem_n", x,
                                   _groups(cfg, x.shape[-1])))
        # SAME 3x3/2 maxpool = pad 1 with -inf, then VALID window
        x = _pad_hw(x, (1, 1), (1, 1), value=-math.inf)
        return ops.maxpool2d(x, window=3, stride=2)
    x = ops.conv2d(x, params["stem_W"], stride=1, padding="SAME")
    return torch.relu(_group_norm(params, "stem_n", x,
                                  _groups(cfg, x.shape[-1])))


def resnet_apply(params: Params, x: torch.Tensor, *,
                 cfg: ResNetConfig = ResNetConfig()) -> torch.Tensor:
    """(N, H, W, C) → (N, n_classes) log-probabilities."""
    x = _stem(params, x, cfg)
    for p, stride, needs_proj, _c_in, c_out in _block_plan(cfg):
        g = _groups(cfg, c_out)
        h = ops.conv2d(x, params[f"{p}_conv1_W"], stride=stride,
                       padding="SAME")
        h = torch.relu(_group_norm(params, f"{p}_n1", h, g))
        h = ops.conv2d(h, params[f"{p}_conv2_W"], stride=1, padding="SAME")
        h = _group_norm(params, f"{p}_n2", h, g)
        if needs_proj:
            x = ops.conv2d(x, params[f"{p}_proj_W"], stride=stride,
                           padding="SAME")
            x = _group_norm(params, f"{p}_np", x, g)
        x = torch.relu(x + h)
    x = x.mean(dim=(1, 2))          # global average pool
    logits = x @ params["fc_W"] + params["fc_b"]
    return ops.log_softmax(logits)


def make_loss(cfg: ResNetConfig):
    """``loss_fn(params, x, y)`` closure for the trainer (mean NLL)."""
    def nll_loss(params, x, y):
        logp = resnet_apply(params, x, cfg=cfg)
        return -logp.gather(1, y.long()[:, None]).mean()
    return nll_loss


def accuracy(params: Params, x: torch.Tensor, y: torch.Tensor, *,
             cfg: ResNetConfig = ResNetConfig()) -> torch.Tensor:
    return (resnet_apply(params, x, cfg=cfg).argmax(dim=1)
            == y.long()).float().mean()


def flops_per_example(cfg: ResNetConfig = ResNetConfig()) -> int:
    """Fwd+bwd matmul-equivalent FLOPs per example (MFU accounting)."""
    h, w, c_in = cfg.input_shape

    def conv_flops(h, w, k, s, c_in, c_out):
        ho, wo = -(-h // s), -(-w // s)     # SAME
        return ho, wo, 2 * ho * wo * k * k * c_in * c_out

    fwd = 0
    if cfg.imagenet_stem:
        h, w, f = conv_flops(h, w, 7, 2, c_in, cfg.widths[0])
        fwd += f
        h, w = -(-h // 2), -(-w // 2)       # 3x3/2 SAME maxpool
    else:
        h, w, f = conv_flops(h, w, 3, 1, c_in, cfg.widths[0])
        fwd += f
    for _p, stride, needs_proj, c_in, c_out in _block_plan(cfg):
        ho, wo, f1 = conv_flops(h, w, 3, stride, c_in, c_out)
        _, _, f2 = conv_flops(ho, wo, 3, 1, c_out, c_out)
        fwd += f1 + f2
        if needs_proj:
            fwd += conv_flops(h, w, 1, stride, c_in, c_out)[2]
        h, w = ho, wo
    fwd += 2 * cfg.widths[-1] * cfg.n_classes
    return 3 * fwd
