"""The paper's own evaluation workloads: Jet-DNN, VGG7, ResNet9.

Paper §V-A: "benchmark workloads from typical DNN applications, including
jet identification (Jet-DNN), image classification using VGG7 and ResNet9
networks.  The datasets used are: Jet-HLF, MNIST and SVHN."

Jet-DNN is the HLS4ML jet-tagging MLP (16 → 64 → 32 → 32 → 5, ReLU).
As in the JAX package's ``models/cnn.py``, each model is ``init(gen,
scale)`` → parameters (nested dicts of tensors, the JAX pytree's keys) and
``apply(ctx, params, x)``, with ``scale`` the SCALING O-task's width
multiplier.  The public layouts are the JAX package's: NHWC inputs and HWIO
convolution weights, permuted inside :func:`conv2d` for ``F.conv2d``.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.common import Ctx, dense_init, linear


# --------------------------------------------------------------- Jet-DNN
JET_FEATURES = 16
JET_CLASSES = 5
JET_WIDTHS = (64, 32, 32)


def init_jet_dnn(gen: torch.Generator, scale: float = 1.0,
                 dtype=torch.float32):
    widths = [max(2, int(round(w * scale))) for w in JET_WIDTHS]
    dims = [JET_FEATURES, *widths, JET_CLASSES]
    params = {}
    for i, (din, dout) in enumerate(zip(dims, dims[1:])):
        params[f"fc{i}"] = {"w": dense_init(gen, din, dout, dtype),
                            "b": torch.zeros((dout,), dtype=dtype,
                                             device=gen.device)}
    return params


def jet_dnn_apply(ctx: Ctx, params, x):
    n = len(params)
    for i in range(n):
        p = params[f"fc{i}"]
        x = linear(ctx, f"fc{i}", x, p["w"], p["b"])
        if i < n - 1:
            x = F.relu(x)
    return x


# ------------------------------------------------------------------ conv
def conv_init(gen: torch.Generator, k: int, cin: int, cout: int,
              dtype=torch.float32):
    scale = 1.0 / math.sqrt(k * k * cin)
    w = torch.randn((k, k, cin, cout), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def conv2d(x, w, stride: int = 1, padding: str = "SAME"):
    """NHWC input, HWIO weight, fp32 arithmetic, output in x's dtype.
    ``SAME`` pads (k - 1) / 2 on each side (odd k at stride 1, the only
    shapes the models use); ``VALID`` pads nothing."""
    kh, kw = w.shape[0], w.shape[1]
    if padding == "SAME":
        if stride != 1 or kh % 2 == 0 or kw % 2 == 0:
            raise ValueError("SAME padding is implemented for odd kernels "
                             "at stride 1")
        pad = ((kh - 1) // 2, (kw - 1) // 2)
    elif padding == "VALID":
        pad = (0, 0)
    else:
        raise ValueError(f"unknown padding {padding!r}")
    y = F.conv2d(x.float().permute(0, 3, 1, 2),
                 w.float().permute(3, 2, 0, 1), stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def max_pool_2x2(x):
    """2x2 max pool, stride 2, ``VALID`` (an odd edge row or column is
    dropped), on NHWC."""
    b, h, w, c = x.shape
    x = x[:, :h // 2 * 2, :w // 2 * 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def _bn_init(c: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((c,), dtype=dtype, device=device),
            "bias": torch.zeros((c,), dtype=dtype, device=device)}


def _bn(p, x, eps=1e-5):
    # batch-independent norm (per-channel layernorm style) — keeps the
    # model purely functional without running statistics.
    xf = x.float()
    mu = xf.mean(dim=(1, 2), keepdim=True)
    var = xf.var(dim=(1, 2), keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


# ------------------------------------------------------------------ VGG7
VGG7_CHANNELS = (64, 64, 128, 128, 256, 256)


def init_vgg7(gen: torch.Generator, scale: float = 1.0, in_ch: int = 1,
              n_classes: int = 10, img: int = 28, dtype=torch.float32):
    chans = [max(4, int(round(c * scale))) for c in VGG7_CHANNELS]
    params: dict[str, Any] = {}
    cin = in_ch
    for i, c in enumerate(chans):
        params[f"conv{i}"] = {"w": conv_init(gen, 3, cin, c, dtype),
                              "bn": _bn_init(c, dtype, gen.device)}
        cin = c
    # three 2x pools over the six convs
    feat = (img // 8) ** 2 * chans[-1]
    params["fc"] = {"w": dense_init(gen, feat, n_classes, dtype),
                    "b": torch.zeros((n_classes,), dtype=dtype,
                                     device=gen.device)}
    return params


def vgg7_apply(ctx: Ctx, params, x):
    i = 0
    while f"conv{i}" in params:
        p = params[f"conv{i}"]
        x = conv2d(x, p["w"])
        x = _bn(p["bn"], x)
        x = F.relu(x)
        if i % 2 == 1:
            x = max_pool_2x2(x)
        i += 1
    x = x.reshape(x.shape[0], -1)
    return linear(ctx, "fc", x, params["fc"]["w"], params["fc"]["b"])


# --------------------------------------------------------------- ResNet9
RES9_CHANNELS = (64, 128, 256, 512)


def init_resnet9(gen: torch.Generator, scale: float = 1.0, in_ch: int = 3,
                 n_classes: int = 10, dtype=torch.float32):
    chans = [max(4, int(round(c * scale))) for c in RES9_CHANNELS]
    dev = gen.device

    def convbn(cin, cout):
        return {"w": conv_init(gen, 3, cin, cout, dtype),
                "bn": _bn_init(cout, dtype, dev)}

    p: dict[str, Any] = {}
    p["stem"] = convbn(in_ch, chans[0])
    p["c1"] = convbn(chans[0], chans[1])
    p["r1a"] = convbn(chans[1], chans[1])
    p["r1b"] = convbn(chans[1], chans[1])
    p["c2"] = convbn(chans[1], chans[2])
    p["c3"] = convbn(chans[2], chans[3])
    p["r2a"] = convbn(chans[3], chans[3])
    p["r2b"] = convbn(chans[3], chans[3])
    p["fc"] = {"w": dense_init(gen, chans[3], n_classes, dtype),
               "b": torch.zeros((n_classes,), dtype=dtype, device=dev)}
    return p


def _convbn(p, x, pool=False):
    x = conv2d(x, p["w"])
    x = _bn(p["bn"], x)
    if pool:
        x = max_pool_2x2(x)
    return F.relu(x)


def resnet9_apply(ctx: Ctx, params, x):
    x = _convbn(params["stem"], x)
    x = _convbn(params["c1"], x, pool=True)
    r = _convbn(params["r1a"], x)
    r = _convbn(params["r1b"], r)
    x = x + r
    x = _convbn(params["c2"], x, pool=True)
    x = _convbn(params["c3"], x, pool=True)
    r = _convbn(params["r2a"], x)
    r = _convbn(params["r2b"], r)
    x = x + r
    x = x.amax(dim=(1, 2))
    return linear(ctx, "fc", x, params["fc"]["w"], params["fc"]["b"])


# ------------------------------------------------------------- factories
BENCH_MODELS = {
    "jet_dnn": (init_jet_dnn, jet_dnn_apply,
                dict(features=JET_FEATURES, classes=JET_CLASSES,
                     input_shape=(JET_FEATURES,))),
    "vgg7": (init_vgg7, vgg7_apply,
             dict(classes=10, input_shape=(28, 28, 1))),
    "resnet9": (init_resnet9, resnet9_apply,
                dict(classes=10, input_shape=(32, 32, 3))),
}


def build_bench_model(name: str, gen: torch.Generator, scale: float = 1.0):
    init_fn, apply_fn, meta = BENCH_MODELS[name]
    params = init_fn(gen, scale=scale)
    return params, apply_fn, meta
