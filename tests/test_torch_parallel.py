"""The port's scale-out against the JAX package and against itself, on the
CPU in fp32, with four gloo ranks (``tests/_torch_dist_worker.py``).

- ``clip_loss_distributed``, global and local: values and gradients against
  JAX's on the conftest's 8-device mesh (``tests/test_clip_loss.py``). Each
  rank back-propagates its copy of the loss, so a rank's rows get dp times
  the JAX gradient (``parallel/collectives.py``).
- One ATM-S data-parallel step at global B 32, dropout off: the loss within
  1e-5, the dp-mean gradients within 1e-4 of the largest, and the updated
  BatchNorm statistics, against JAX's GSPMD step on the 8-device mesh.
- Seeded dropout at every site: the 4-rank epoch equals the port's one-rank
  epoch at the global batch (losses within 1e-6 relative), the ranks'
  parameters are bit-equal, the sample-sharded epoch equals the replicated
  epoch over the same rows, and the streamed epoch the resident one.
- The tiny UNet on a dp × mp = 2 × 2 mesh against JAX's tensor-parallel
  forward (``tests/test_gen_sharding.py``), within 1e-4.
- ``parallel/multihost.py``: the bootstrap never falls back to one process
  when the environment names a larger job (JAX ``tests/test_multihost.py``),
  ``core/mesh.py``'s checks, and the CLI's scale-out errors.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from eeg_image_decode_tpu.core.config import ATMSConfig as JaxATMSConfig
from eeg_image_decode_tpu.core.mesh import create_mesh as jax_create_mesh
from eeg_image_decode_tpu.gen import sharding as jsharding
from eeg_image_decode_tpu.gen import unet as junet
from eeg_image_decode_tpu.losses import clip_loss as jax_clip_loss
from eeg_image_decode_tpu.losses.clip_loss import (
    clip_loss_distributed as jax_clip_loss_distributed,
)
from eeg_image_decode_tpu.losses.clip_loss import (
    retrieval_loss as jax_retrieval_loss,
)
from eeg_image_decode_tpu.models import build_encoder as jax_build_encoder
from eeg_image_decode_tpu.train import contrastive as jax_contrastive
from eeg_image_decode_tpu_torch import cli
from eeg_image_decode_tpu_torch.core.config import (
    ATMSConfig,
    ContrastiveTrainConfig,
)
from eeg_image_decode_tpu_torch.core.mesh import (
    create_mesh,
    validate_dp_batch,
)
from eeg_image_decode_tpu_torch.data.synthetic import (
    make_synthetic_retrieval_data,
)
from eeg_image_decode_tpu_torch.gen.unet import SDXLUNetConfig
from eeg_image_decode_tpu_torch.models.registry import build_encoder
from eeg_image_decode_tpu_torch.parallel import multihost
from eeg_image_decode_tpu_torch.train.contrastive import (
    ContrastiveTrainer,
    sharded_epoch_perm,
    sharded_perm_rows,
)
from eeg_image_decode_tpu_torch.utils.convert import params_from_flax
from torch_port_case import SMALL, launch_ranks, randomize
from torch_port_case import two_threads  # noqa: F401 (autouse)

W = 4
C, T = SMALL["n_channels"], SMALL["seq_len"]
NO_DROPOUT = {**SMALL, "dropout": 0.0, "conv_dropout": 0.0,
              "proj_dropout": 0.0}
B_STEP = 32


def _atms_case():
    """JAX ATM-S variables redrawn from a numpy seed, and a global batch."""
    rng = np.random.default_rng(140)
    eeg = (rng.normal(size=(B_STEP, C, T)) * 0.5).astype(np.float32)
    sids = rng.integers(0, SMALL["num_subjects"], B_STEP).astype(np.int32)
    d = SMALL["proj_dim"]
    img = rng.normal(size=(B_STEP, d)).astype(np.float32)
    img /= np.linalg.norm(img, axis=1, keepdims=True)
    text = rng.normal(size=(B_STEP, d)).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    jmodel = jax_build_encoder("atms", config=JaxATMSConfig(**NO_DROPOUT))
    variables = jax.jit(lambda x, s: jmodel.init(
        jax.random.key(0), x, s, deterministic=True))(
        jnp.asarray(eeg[:2]), jnp.asarray(sids[:2]))
    return jmodel, randomize(variables, 141), eeg, sids, img, text


def _tiny_unet():
    cfg = junet.SDXLUNetConfig.tiny()
    jm = junet.SDXLUNet(cfg, dtype=jnp.float32)
    params = jm.init(jax.random.key(0), jnp.zeros((4, 8, 8, 4)),
                     jnp.zeros((4,), jnp.int32),
                     jnp.zeros((4, 4, cfg.cross_attention_dim)), None, None,
                     jnp.zeros((4, cfg.ip_image_embed_dim)))["params"]
    return cfg, jm, randomize({"params": params}, 142)["params"]


def _seeded_inputs():
    train, test = make_synthetic_retrieval_data(
        n_classes=16, images_per_class=2, train_reps=2, n_channels=C,
        n_timepoints=T, clip_dim=SMALL["proj_dim"], seed=143, device="cpu")
    return {"cfg": {**SMALL, "fused_projection": True}, "seed": 3,
            "tcfg": ContrastiveTrainConfig(batch_size=16, eval_ks=(2, 4)),
            "train": train, "test": test}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("world4"))
    rng = np.random.default_rng(144)
    clip = {"a": torch.from_numpy(rng.normal(size=(32, 16)).astype(
        np.float32)), "b": torch.from_numpy(rng.normal(size=(32, 16)).astype(
            np.float32)), "scale": torch.tensor(1.3)}
    torch.save(clip, os.path.join(d, "clip_loss.pt"))

    jmodel, variables, eeg, sids, img, text = _atms_case()
    torch.save({"cfg": NO_DROPOUT, "state": params_from_flax(variables),
                "eeg": torch.from_numpy(eeg),
                "sids": torch.from_numpy(sids).long(),
                "idx": torch.arange(B_STEP), "img": torch.from_numpy(img),
                "text": torch.from_numpy(text)},
               os.path.join(d, "atms_step.pt"))

    seeded = _seeded_inputs()
    torch.save(seeded, os.path.join(d, "seeded.pt"))

    ucfg, jm, tree = _tiny_unet()
    lat = rng.normal(size=(4, 8, 8, 4)).astype(np.float32)
    ctx = rng.normal(size=(4, 4, ucfg.cross_attention_dim)).astype(np.float32)
    emb = rng.normal(size=(4, ucfg.ip_image_embed_dim)).astype(np.float32)
    t = np.asarray([0, 100, 500, 900], np.int32)
    state = {k[len("unet."):]: v for k, v in params_from_flax(
        {"unet": tree}).items()}
    torch.save({"state": state,
                "lat": torch.from_numpy(lat).permute(0, 3, 1, 2).contiguous(),
                "t": torch.from_numpy(t).long(), "ctx": torch.from_numpy(ctx),
                "emb": torch.from_numpy(emb)}, os.path.join(d, "unet_tp.pt"))

    out = launch_ranks(W, d, ["clip_loss", "atms_step", "seeded", "unet_tp"])
    out["jax"] = {"atms": (jmodel, variables, eeg, sids, img, text),
                  "clip": clip, "unet": (jm, tree, lat, t, ctx, emb)}
    out["seeded_inputs"] = seeded
    return out


@pytest.mark.parametrize("local", [False, True], ids=["global", "local"])
def test_clip_loss_distributed_matches_jax(world4, mesh8, local):
    clip = world4["jax"]["clip"]
    a, b = jnp.asarray(clip["a"].numpy()), jnp.asarray(clip["b"].numpy())
    scale = jnp.asarray(1.3)

    def f(x, y):
        return jax_clip_loss_distributed(x, y, scale, mesh=mesh8,
                                         local_loss=local)

    want, (ga, gb) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(a, b)
    key = "local" if local else "global"
    ranks = [r[key] for r in world4["clip_loss"]]
    for r in ranks:  # the same scalar on every rank
        np.testing.assert_allclose(float(r["loss"]), float(want), rtol=1e-5)
    single = float(jax_clip_loss(a, b, scale))
    np.testing.assert_allclose(float(ranks[0]["loss"]), single, rtol=1e-5)
    got_a = torch.cat([r["ga"] for r in ranks]).numpy() / W
    got_b = torch.cat([r["gb"] for r in ranks]).numpy() / W
    np.testing.assert_allclose(got_a, np.asarray(ga), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got_b, np.asarray(gb), rtol=1e-4, atol=1e-6)


def test_atms_dp_step_matches_jax_dp_step(world4, mesh8):
    """Global B 32 over 4 gloo ranks against JAX's GSPMD step over 8 CPU
    devices, dropout off: the same global-batch step on both sides."""
    jmodel, variables, eeg, sids, img, text = world4["jax"]["atms"]
    shard = NamedSharding(mesh8, P("dp"))
    repl = NamedSharding(mesh8, P())

    def loss_fn(params, x, s, i, t):
        (feats, scale), upd = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            x, s, deterministic=False, mutable=["batch_stats"])
        return jax_retrieval_loss(feats.astype(jnp.float32), i, t,
                                  scale), upd

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                   in_shardings=(repl, shard, shard, shard, shard))
    (loss_j, upd), grads_j = step(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        jnp.asarray(eeg), jnp.asarray(sids), jnp.asarray(img),
        jnp.asarray(text))
    want = params_from_flax({"params": jax.tree_util.tree_map(np.asarray,
                                                              grads_j)})
    largest = max(float(g.abs().max()) for g in want.values())
    for r in world4["atms_step"]:
        assert abs(float(r["loss"]) - float(loss_j)) <= 1e-5
        got = r["grads"]
        assert set(got) == set(want)
        worst = max(float((got[k] - want[k]).abs().max()) for k in want)
        assert worst <= 1e-4 * largest, (worst, largest)
        stats = params_from_flax({"batch_stats": jax.tree_util.tree_map(
            np.asarray, upd["batch_stats"])})
        for k, v in stats.items():
            np.testing.assert_allclose(r["buffers"][k].numpy(), v.numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=k)


def _one_rank_reference(inp, **kw):
    model = build_encoder("atms", config=ATMSConfig(**inp["cfg"]),
                          device="cpu", seed=inp["seed"])
    tr = ContrastiveTrainer(model, inp["tcfg"], inp["train"], inp["test"],
                            device="cpu", **kw)
    return tr


def test_seeded_dp_epoch_equals_one_rank_epoch(world4):
    """Every dropout site on (the attention and projection seed modes at
    the rank's sample offset, the torch.rand sites drawn for the global
    batch): the 4-rank epoch is the one-rank epoch of the global batch."""
    tr = _one_rank_reference(world4["seeded_inputs"])
    tr.train_epoch(0)
    want = np.asarray(tr.last_steps["step_loss"])
    assert len(want) == 4
    for r in world4["seeded"]:
        np.testing.assert_allclose(np.asarray(r["loss"]), want, rtol=1e-6)


def test_ranks_hold_bit_equal_parameters(world4):
    first = world4["seeded"][0]["params"]
    for r in world4["seeded"][1:]:
        for k, v in first.items():
            assert torch.equal(r["params"][k], v), k


def test_sharded_epoch_matches_replicated_epoch_over_same_rows(world4):
    """shard_samples keeps N/dp rows a rank; over the same global rows the
    replicated epoch takes the same steps (JAX
    tests/test_sharded_resident_data.py)."""
    n = world4["seeded_inputs"]["train"].n
    for r in world4["seeded"]:
        assert r["sharded_rows"] == n // W
        np.testing.assert_allclose(r["sharded_loss"],
                                   r["repl_same_rows_loss"], rtol=1e-6)


def test_streamed_dp_epoch_matches_resident_dp_epoch(world4):
    for r in world4["seeded"]:
        np.testing.assert_allclose(r["streamed_loss"], r["loss"], rtol=1e-6)


def test_sharded_epoch_perm_is_the_jax_formula():
    for n, b, dp, seed, epoch in ((64, 16, 4, 0, 0), (96, 24, 2, 5, 3)):
        np.testing.assert_array_equal(
            sharded_epoch_perm(n, b, dp, seed, epoch),
            jax_contrastive.sharded_epoch_perm(n, b, dp, seed, epoch))
    perm = sharded_epoch_perm(64, 16, 4, 1, 0)
    rows = sharded_perm_rows(perm, 64, 4)
    assert sorted(rows.reshape(-1).tolist()) == list(range(64))
    with pytest.raises(ValueError, match="divisible"):
        sharded_epoch_perm(66, 16, 4, 0, 0)


def test_tensor_parallel_unet_matches_jax(world4):
    jm, tree, lat, t, ctx, emb = world4["jax"]["unet"]
    mesh = jax_create_mesh(data_parallel=2, model_parallel=2)
    fwd = jsharding.sharded_unet_apply(jm, mesh)
    want = np.asarray(fwd(jsharding.shard_params(mesh, tree),
                          jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx),
                          jnp.asarray(emb)))
    scale = np.abs(want).max()
    for r in world4["unet_tp"]:
        got = r["out"].permute(0, 2, 3, 1).numpy()
        assert np.abs(got - want).max() <= 1e-4 * scale
        # every rank holds a part of the split layers only
        assert r["params"] < r["params_full"]


def test_unet_sharding_rules_follow_the_jax_rule():
    from types import SimpleNamespace

    from eeg_image_decode_tpu_torch.gen.sharding import param_sharding_rules
    from eeg_image_decode_tpu_torch.gen.unet import SDXLUNet

    rules = param_sharding_rules(SimpleNamespace(mp=4),
                                 SDXLUNet(SDXLUNetConfig.tiny()))
    assert rules["conv_in"]          # 32 output channels: 32 % 4 == 0
    assert rules["conv_out"]         # 4 output channels: 4 % 4 == 0
    rules = param_sharding_rules(SimpleNamespace(mp=8),
                                 SDXLUNet(SDXLUNetConfig.tiny()))
    assert rules["conv_in"] and not rules["conv_out"]     # 4 < 8


def test_initialize_never_falls_back_when_a_job_is_named(monkeypatch):
    """A process the environment names as one of several must join them or
    raise; the raise names what is missing (JAX
    tests/test_multihost.py:83)."""
    for var in (*multihost.LAUNCHER_VARS, "SLURM_NTASKS",
                "OMPI_COMM_WORLD_SIZE", "PMI_SIZE"):
        monkeypatch.delenv(var, raising=False)
    for var, value in (("SLURM_NTASKS", "4"), ("OMPI_COMM_WORLD_SIZE", "2"),
                       ("PMI_SIZE", "8"), ("WORLD_SIZE", "2")):
        monkeypatch.setenv(var, value)
        with pytest.raises(RuntimeError, match="MASTER_ADDR"):
            multihost.initialize(device="cpu")
        monkeypatch.delenv(var)

    def boom(*a, **kw):
        raise RuntimeError("connection refused by the rendezvous")

    # the launcher's variables set: a failing bootstrap propagates
    monkeypatch.setattr(multihost.dist, "init_process_group", boom)
    for var, value in (("RANK", "1"), ("WORLD_SIZE", "2"),
                       ("MASTER_ADDR", "10.0.0.1"), ("MASTER_PORT", "1234")):
        monkeypatch.setenv(var, value)
    with pytest.raises(RuntimeError, match="connection refused"):
        multihost.initialize(device="cpu")
    assert not torch.distributed.is_initialized()


def test_initialize_alone_is_a_group_of_one_and_idempotent():
    code = ("from eeg_image_decode_tpu_torch.parallel import multihost;"
            "from eeg_image_decode_tpu_torch.core.mesh import create_mesh;"
            "a = multihost.initialize(device='cpu');"
            "b = multihost.initialize(device='cpu');"
            "m = create_mesh(device='cpu');"
            "print(a, b, m.dp, m.mp, multihost.is_multiprocess())")
    env = {k: v for k, v in os.environ.items()
           if k not in (*multihost.LAUNCHER_VARS, "SLURM_NTASKS",
                        "OMPI_COMM_WORLD_SIZE", "PMI_SIZE")}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["(0,", "1)", "(0,", "1)", "1", "1",
                                  "False"]


def test_mesh_checks_and_feeding_helpers():
    from types import SimpleNamespace

    from eeg_image_decode_tpu_torch.core.mesh import Mesh

    with pytest.raises(RuntimeError, match="initialize"):
        create_mesh(device="cpu")
    assert not multihost.is_multiprocess()
    # rank 5 of a 4 × 2 grid: dp row 2 of 4
    mesh = Mesh(dp=4, mp=2, rank=5, dp_rank=2, mp_rank=1, dp_group=None,
                mp_group=None, device=torch.device("cpu"))
    assert multihost.process_local_slice(16, mesh) == slice(8, 12)
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    got = multihost.shard_global_batch(mesh, {"x": x[8:12]}, global_rows=16)
    assert torch.equal(got["x"], torch.from_numpy(x[8:12]))
    with pytest.raises(ValueError, match="owns 16/4"):
        multihost.shard_global_batch(mesh, {"x": x}, global_rows=16)
    assert torch.equal(multihost.replicate_global(mesh, {"x": x})["x"],
                       torch.from_numpy(x))
    with pytest.raises(ValueError, match="18 rows do not split into dp=4"):
        mesh.rows(18)
    validate_dp_batch(None, 7)
    with pytest.raises(ValueError, match="multiple of 4"):
        validate_dp_batch(SimpleNamespace(dp=4), 30)


def test_cli_scale_out_errors(monkeypatch, tmp_path):
    for var in multihost.LAUNCHER_VARS:
        monkeypatch.delenv(var, raising=False)
    base = ["train-retrieval", "--data-path", str(tmp_path), "--features",
            str(tmp_path / "f.npz"), "--device", "cpu"]
    with pytest.raises(SystemExit, match="RANK, WORLD_SIZE, MASTER_ADDR, "
                                         "MASTER_PORT not set"):
        cli.main([*base, "--multihost"])
    with pytest.raises(SystemExit, match="--shard-data needs --mesh"):
        cli.main([*base, "--shard-data"])
    with pytest.raises(SystemExit, match="exclusive"):
        cli.main([*base, "--shard-data", "--streaming"])
