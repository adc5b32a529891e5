"""The attention layer's forward kernels (``csrc/attention_fwd.cu``, the
training forward with its seeded dropout and the evaluation's forward):
the least time their work needs on the card over the device time of their
kernels in the traced epoch. Products in bf16; bytes the input, the
weights and the output once."""

from benchmarks.harness import stats
from benchmarks.harness import work as attention

UNIT = "%"
LAYER = "kernels (ops/attention.py, csrc/attention_*.cu)"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"


def read(rec: dict):
    if not rec.get("traced_steps") or "kernels" not in rec:
        return None
    fwd_s, _ = attention.device_seconds(rec["kernels"])
    if fwd_s <= 0:
        return None
    m, b = rec["config"]["model"], rec["config"]["train"]["batch_size"]
    bound = rec["traced_steps"] * stats.bound_s(
        *attention.forward_work(m, b), "bfloat16")
    if rec.get("traced_eval_rows"):
        bound += stats.bound_s(
            *attention.forward_work(m, rec["traced_eval_rows"]), "bfloat16")
    return 100.0 * bound / fwd_s
