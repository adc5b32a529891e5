import statistics

import numpy as np
import pytest
import torch

from benchmarks.harness import spec, stats, trace, work
from benchmarks.tests import small


def _metric(name, cell="atms_train_resident"):
    c = spec.load_cell(cell)
    entry = next(m for m in c.end_to_end + c.per_layer if m["name"] == name)
    return spec.reader(c, entry)


def test_rate_is_all_the_work_over_all_the_window():
    rec = {"samples": 7 * 1024, "window_s": 2.5}
    assert _metric("train_samples_per_s").read(rec) == 7 * 1024 / 2.5


def test_streamed_rate_and_peak_memory():
    rec = {"samples": 7 * 1024, "window_s": 2.5,
           "memory_peak_bytes": 1_698_707_968}
    streamed = "atms_train_streamed"
    assert _metric("train.samples_per_s.streamed", streamed).read(rec) == (
        _metric("train_samples_per_s").read(rec))
    assert _metric("train_memory_peak_gb", streamed).read(rec) == (
        1.698707968)
    assert _metric("train_memory_peak_gb", streamed).read({}) is None


def test_p95_is_over_every_request():
    lat = list(np.random.default_rng(0).exponential(100.0, 997))
    rec = {"latencies_ms": lat}
    got = _metric("recon_latency_p95_ms", "recon_poisson_rows1").read(rec)
    assert got == statistics.quantiles(lat, n=20)[18]
    assert sorted(lat)[int(0.93 * 997)] < got < sorted(lat)[int(0.97 * 997)]


def test_idle_share_is_one_minus_the_union_of_kernels():
    kernels = [(0.0, 4.0), (2.0, 6.0), (8.0, 9.0), (8.5, 8.7)]
    assert stats.union_length(kernels) == 7.0
    rec = {"kernels": kernels, "busy_s": 7.0, "trace_window_s": 10.0}
    assert _metric("device.idle_share.train").read(rec) == pytest.approx(30)
    assert stats.gaps(kernels, (0.0, 10.0)) == [(6.0, 8.0), (9.0, 10.0)]


def test_idle_gaps_named_by_the_host():
    host = [(0.0, 10.0, "outer"), (5.5, 8.5, "cudaStreamSynchronize")]
    out = trace.idle_by_host([(0.0, 5.0), (9.0, 10.0)], (0.0, 10.0), host)
    assert out == [["cudaStreamSynchronize", 4.0 / 1e6]]


def test_roofline_bytes_count_each_input_and_output_once():
    m = dict(d_model=8, n_heads=2, n_channels=3, d_ff=16)
    length, d, weights = 4, 8, 4 * 8 * 8 + 2 * 8 * 16
    _, fwd_bytes = work.forward_work(m, 5)
    assert fwd_bytes == 2 * (5 * length * d * 2 + weights)
    flops, bwd_bytes = work.backward_work(m, 5)
    assert flops == 2 * work.forward_work(m, 5)[0]
    assert bwd_bytes == 2 * (3 * 5 * length * d + weights) + 4 * weights
    # the bound is the larger of the two times
    assert stats.bound_s(1e12, 1.0, "bfloat16") == 1e12 / 989e12
    assert stats.bound_s(1.0, 3.35e12, "bfloat16") == 1.0


def test_roofline_attributes_the_pack_kernel_to_the_launch_after_it():
    k = [("attention_pack_kernel", 0, 1), ("attention_fwd_mma_kernel", 1, 4),
         ("elementwise", 4, 9), ("attention_pack_kernel", 9, 10),
         ("attention_bwd_mma_rows_kernel", 10, 20),
         ("attention_dw_mma_kernel", 20, 22)]
    fwd, bwd = work.device_seconds(k)
    assert (fwd, bwd) == (4e-6, 13e-6)


def test_roofline_reads_nothing_without_kernel_time():
    rec = {"traced_steps": 3, "kernels": [("gemm", 0, 5)],
           "config": small.training_cell().config}
    assert _metric("attention_bwd_roofline").read(rec) is None


def test_mfu_counts_the_reference_step():
    from benchmarks.drivers import train_contrastive as tc

    cell = small.training_cell(batch=8)
    flops = tc.step_flops(cell)
    m = cell.config["model"]
    # the attention layer's products alone, forward and backward, are part
    # of the count
    fwd, _ = work.forward_work(m, 8)
    assert 3 * fwd < flops
    rec = {"steps": 10, "flops_per_step": flops, "window_s": 2.0,
           "chips": 1, "peak_dtype": "bfloat16"}
    assert _metric("train_mfu").read(rec) == pytest.approx(
        100 * 10 * flops / 2.0 / 989e12)


def test_weights_are_the_same_on_both_sides():
    from benchmarks.harness import weights

    a = {"x.kernel": torch.empty(300, 40), "x.bias": torch.empty(40),
         "n.scale": torch.empty(40)}
    b = {k: torch.empty_like(v) for k, v in a.items()}
    weights.fill_(list(a.items()), 2**31 + 5, "t")
    weights.fill_(list(b.items()), 2**31 + 5, "t")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert 0.04 < float(a["x.kernel"].std()) < 0.07  # 1/sqrt(300)
    c = {k: torch.empty_like(v) for k, v in a.items()}
    weights.fill_(list(c.items()), 2**31 + 6, "t")
    assert not torch.equal(a["x.kernel"], c["x.kernel"])
