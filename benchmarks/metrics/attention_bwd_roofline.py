"""The attention layer's backward kernels (``csrc/attention_bwd.cu``): the
least time its work needs on the card over the device time of its kernels
in the traced epoch. The work is the forward's products twice (the input
and the weight gradients; a recompute is not counted), in bf16; its bytes
the input, the output gradient, the weights read once and the input and
weight gradients written once."""

from benchmarks.harness import stats
from benchmarks.harness import work as attention

UNIT = "%"
LAYER = "kernels (ops/attention.py, csrc/attention_*.cu)"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"


def read(rec: dict):
    if not rec.get("traced_steps") or "kernels" not in rec:
        return None
    fwd_s, bwd_s = attention.device_seconds(rec["kernels"])
    if bwd_s <= 0:
        return None
    m, b = rec["config"]["model"], rec["config"]["train"]["batch_size"]
    flops, nbytes = attention.backward_work(m, b)
    bound = stats.bound_s(flops, nbytes, "bfloat16") * rec["traced_steps"]
    return 100.0 * bound / bwd_s
