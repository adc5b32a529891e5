"""Operations and bytes of a layer's work, worked out from its shapes, and
the device time of the kernels that implement it in a trace. Each input
byte is counted read once and each output byte written once, whatever a
kernel reads again, so a bound reads the same work whatever implements
it."""

from __future__ import annotations

BF16, FP32 = 2, 4

#: kernel-name parts of the attention layer's forward and backward; the
#: weight-packing kernel that both launch belongs to the launch after it
ATTENTION_FWD = ("attention_fwd",)
ATTENTION_BWD = ("attention_bwd", "attention_dw")
ATTENTION_PACK = ("attention_pack",)


def attention_dims(m: dict) -> tuple[int, int, int, int, int, int]:
    d, h = m["d_model"], m["n_heads"]
    hd = d // h
    return m["n_channels"] + 1, d, h, hd, h * hd, m["d_ff"]


def forward_work(m: dict, batch: int) -> tuple[float, float]:
    """(operations, bytes) of one post-norm attention layer's forward over
    ``batch`` samples: QKV, scores, probabilities × V, the output
    projection and the FFN's two products; the input, the weights (bf16)
    and the output."""
    length, d, h, hd, inner, ff = attention_dims(m)
    flops = batch * 2 * length * (3 * d * inner + 2 * h * length * hd
                                  + inner * d + 2 * d * ff)
    weights = 4 * d * inner + 2 * d * ff
    nbytes = BF16 * (2 * batch * length * d + weights)
    return float(flops), float(nbytes)


def backward_work(m: dict, batch: int) -> tuple[float, float]:
    """(operations, bytes) of the layer's backward: the forward's products
    twice (the input and the weight gradients); the input and the output
    gradient read, the input gradient (bf16) and the weight gradients
    (fp32) written."""
    length, d, h, hd, inner, ff = attention_dims(m)
    flops, _ = forward_work(m, batch)
    weights = 4 * d * inner + 2 * d * ff
    nbytes = (BF16 * (3 * batch * length * d + weights) + FP32 * weights)
    return 2.0 * flops, float(nbytes)


def _has(name: str, parts) -> bool:
    return any(p in name for p in parts)


def device_seconds(kernels) -> tuple[float, float]:
    """(forward, backward) device seconds of the attention layer's kernels
    among ``kernels`` [(name, start µs, end µs)]."""
    fwd = bwd = 0.0
    pending = 0.0
    for name, a, b in sorted(kernels, key=lambda k: k[1]):
        if _has(name, ATTENTION_PACK):
            pending += b - a
        elif _has(name, ATTENTION_FWD):
            fwd += b - a + pending
            pending = 0.0
        elif _has(name, ATTENTION_BWD):
            bwd += b - a + pending
            pending = 0.0
    return fwd / 1e6, bwd / 1e6
