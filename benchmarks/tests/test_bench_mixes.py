import numpy as np

from benchmarks.drivers import reconstruct as rc
from benchmarks.drivers import train_contrastive as tc
from benchmarks.harness import eegdata, spec


def test_open_loop_arrivals_follow_the_seed():
    mix = spec.load_cell("recon_poisson_rows1").mix
    a = rc.schedule(mix, 30.0, 2**31 + 11)
    assert np.array_equal(a, rc.schedule(mix, 30.0, 2**31 + 11))
    b = rc.schedule(mix, 30.0, 2**31 + 12)
    assert not np.array_equal(a, b)
    # every seed: the same set of gaps, in another order
    assert len(a) == len(b) == round(30 * mix["rate_per_s"])
    ga, gb = np.sort(np.diff(a)), np.sort(np.diff(b))
    n = min(len(ga), len(gb)) - 5
    assert np.abs(ga[5:n] - gb[5:n]).max() < 0.02
    assert a[-1] < 30.0 and np.all(np.diff(a) >= 0)


def test_requests_follow_the_seed():
    mix = spec.load_cell("recon_poisson_rows1").mix
    pool = np.arange(8 * 2 * 3, dtype=np.float32).reshape(8, 2, 3)
    a = rc.requests(mix, 2**31 + 11, 20, pool)
    b = rc.requests(mix, 2**31 + 11, 20, pool)
    c = rc.requests(mix, 2**31 + 12, 20, pool)
    for x, y in zip(a, b):
        assert all(np.array_equal(x[k], y[k])
                   for k in ("eeg", "sids", "row_seeds"))
    assert any(not np.array_equal(x["row_seeds"], y["row_seeds"])
               for x, y in zip(a, c))
    assert all(r["eeg"].shape == (1, 2, 3) and 0 <= r["sids"][0] <= 9
               for r in a)


def test_training_epochs_follow_the_seed():
    a = tc.epoch_rows(1000, 100, 7, 3)
    assert np.array_equal(a, tc.epoch_rows(1000, 100, 7, 3))
    assert not np.array_equal(a, tc.epoch_rows(1000, 100, 8, 3))
    assert len(set(a.ravel())) == 1000  # every row once an epoch


def test_split_follows_the_seed():
    d = dict(spec.load_cell("atms_train_resident").config["data"],
             n_classes=4, n_test_classes=2)
    a = eegdata.make_split(d, 2**31 + 3, "cpu")
    b = eegdata.make_split(d, 2**31 + 3, "cpu")
    c = eegdata.make_split(d, 2**31 + 4, "cpu")
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["eeg"], c["eeg"])
    assert a["eeg"].shape == (4 * 10 * 4, 63, 250)
