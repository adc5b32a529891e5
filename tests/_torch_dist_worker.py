"""One rank of the port's data-parallel CPU tests (the counterpart of the JAX
package's ``tests/_multihost_child.py``). Imports no JAX.

    python tests/_torch_dist_worker.py RANK WORLD RENDEZVOUS_FILE DIR CASE...

joins a gloo group of WORLD ranks through ``file://RENDEZVOUS_FILE``
(no TCP port to race for), then runs each named case on the inputs the
parent wrote to ``DIR/<case>.pt`` and writes ``DIR/<case>_r<RANK>.pt``.
Each rank keeps to two threads.
"""

import os
import sys

import torch

torch.set_num_threads(2)
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

from eeg_image_decode_tpu_torch.core.config import (  # noqa: E402
    ATMSConfig,
    ContrastiveTrainConfig,
)
from eeg_image_decode_tpu_torch.core.mesh import create_mesh  # noqa: E402
from eeg_image_decode_tpu_torch.models.registry import (  # noqa: E402
    build_encoder,
)
from eeg_image_decode_tpu_torch.parallel import multihost  # noqa: E402
from eeg_image_decode_tpu_torch.parallel.collectives import (  # noqa: E402
    pmean_tree,
)


def _mesh():
    return create_mesh(device="cpu")


def case_clip_loss(inp, mesh):
    """clip_loss_distributed, global and local: values and the gradients
    of this rank's rows."""
    from eeg_image_decode_tpu_torch.losses import clip_loss_distributed

    rows = mesh.rows(inp["a"].shape[0])
    out = {}
    for local in (False, True):
        a = inp["a"][rows].clone().requires_grad_(True)
        b = inp["b"][rows].clone().requires_grad_(True)
        loss = clip_loss_distributed(a, b, inp["scale"], mesh=mesh,
                                     local_loss=local)
        loss.backward()
        out["local" if local else "global"] = {
            "loss": loss.detach(), "ga": a.grad, "gb": b.grad}
    return out


def _atms(inp):
    model = build_encoder("atms", config=ATMSConfig(**inp["cfg"]),
                          device="cpu")
    model.load_state_dict(inp["state"], strict=True)
    return model


def case_atms_step(inp, mesh):
    """One dp step of ATM-S at the global batch, dropout off: the loss, the
    dp-mean gradients and the updated BatchNorm statistics."""
    from eeg_image_decode_tpu_torch.train.contrastive import (
        batch_loss,
        with_features,
    )

    model = _atms(inp).train()
    rows = mesh.rows(inp["eeg"].shape[0])
    batch = with_features(
        {"eeg": inp["eeg"][rows], "subject_ids": inp["sids"][rows],
         "img_idx": inp["idx"][rows], "text_idx": inp["idx"][rows],
         "labels": inp["idx"][rows]},
        inp["img"], inp["text"], mesh)
    loss, _ = batch_loss(model, ContrastiveTrainConfig(), batch, mesh=mesh)
    loss.backward()
    pmean_tree(model.parameters(), mesh)
    return {"loss": loss.detach(),
            "grads": {k: p.grad for k, p in model.named_parameters()},
            "buffers": dict(model.named_buffers())}


def _trainer(inp, mesh, **kw):
    from eeg_image_decode_tpu_torch.train.contrastive import (
        ContrastiveTrainer,
    )

    model = build_encoder("atms", config=ATMSConfig(**inp["cfg"]),
                          device="cpu", seed=inp["seed"])
    return ContrastiveTrainer(model, inp["tcfg"], inp["train"], inp["test"],
                              mesh=mesh, **kw)


def case_seeded(inp, mesh):
    """Seeded dropout through every site: each step's loss and the final
    parameters, replicated; and the sample-sharded epoch with the
    replicated epoch over the same rows."""
    from eeg_image_decode_tpu_torch.train.contrastive import (
        sharded_perm_rows,
    )

    tr = _trainer(inp, mesh)
    tr.train_epoch(0)
    out = {"loss": tr.last_steps["step_loss"],
           "params": {k: v.detach().clone()
                      for k, v in tr.model.state_dict().items()}}
    sharded = _trainer(inp, mesh, shard_samples=True)
    sharded.train_epoch(0)
    repl = _trainer(inp, mesh)
    n, bs = inp["train"].n, inp["tcfg"].batch_size
    repl.train_epoch(0, perm=sharded_perm_rows(sharded.epoch_perm(0), n,
                                               mesh.dp))
    out["sharded_loss"] = sharded.last_steps["step_loss"]
    out["repl_same_rows_loss"] = repl.last_steps["step_loss"]
    out["sharded_rows"] = int(sharded.data.eeg.shape[0])
    streamed = _trainer(inp, mesh, streaming=True)
    streamed.train_epoch(0)
    streamed.close()
    out["streamed_loss"] = streamed.last_steps["step_loss"]
    return out


def case_prior(inp, mesh):
    from eeg_image_decode_tpu_torch.train.prior import PriorPipe

    pipe = PriorPipe(inp["cfg"], mesh=mesh)
    hist = pipe.train(inp["c"], inp["h"], epochs=2, log_fn=None)
    return {"loss": [r["loss"] for r in hist],
            "params": {k: v.clone() for k, v in
                       pipe.model.state_dict().items()}}


def case_lowlevel(inp, mesh):
    from eeg_image_decode_tpu_torch.models.lowlevel import EncoderLowLevel
    from eeg_image_decode_tpu_torch.train.lowlevel import LowLevelTrainer

    tr = LowLevelTrainer(inp["cfg"], mesh=mesh,
                         model=EncoderLowLevel(**inp["model"]))
    hist = tr.train(inp["eeg"], inp["lat"], epochs=2, log_fn=None)
    return {"loss": [r["loss"] for r in hist],
            "params": {k: v.clone() for k, v in
                       tr.model.state_dict().items()}}


def case_sweep(inp, mesh):
    from eeg_image_decode_tpu_torch.train.sweep import SubjectParallelSweep

    sweep = SubjectParallelSweep(
        lambda seed: build_encoder("atms", config=ATMSConfig(**inp["cfg"]),
                                   device="cpu", seed=seed),
        inp["tcfg"], inp["trains"], inp["tests"], mesh=mesh,
        seeds=inp["seeds"])
    history = sweep.fit(2, log_fn=None)
    return {"history": history, "lanes": sweep.lanes,
            "params": {i: {k: v.clone() for k, v in
                           sweep.subject_trainer(i).model.state_dict()
                           .items()} for i in sweep.lanes
                       if i not in sweep.failed}}


def case_cli(inp, mesh):
    """``train-retrieval --mesh`` in this process (the group is joined)."""
    from eeg_image_decode_tpu_torch import cli

    out = os.path.join(inp["dir"], f"out_r{mesh.rank}")
    cli.main([*inp["argv"], "--output-dir", out, "--mesh"])
    return {"out": out}


def case_unet_tp(inp, mesh):
    """The tiny UNet on a dp × mp = 2 × 2 mesh."""
    from eeg_image_decode_tpu_torch.gen.sharding import (
        shard_params,
        sharded_unet_apply,
    )
    from eeg_image_decode_tpu_torch.gen.unet import (
        SDXLUNet,
        SDXLUNetConfig,
    )

    tp = create_mesh(data_parallel=2, model_parallel=2, device="cpu")
    unet = SDXLUNet(SDXLUNetConfig.tiny())
    unet.load_state_dict(inp["state"], strict=True)
    n_full = sum(p.numel() for p in unet.parameters())
    shard_params(tp, unet)
    fwd = sharded_unet_apply(unet, tp)
    return {"out": fwd(inp["lat"], inp["t"], inp["ctx"], inp["emb"]),
            "params": sum(p.numel() for p in unet.parameters()),
            "params_full": n_full}


def case_gram_stats(inp, mesh):
    """GramStage1BN's affine on this rank's rows under the mesh, and the
    gradients of a probe of (mul, add) to the rows and the taps."""
    from eeg_image_decode_tpu_torch.models.layers import GramStage1BN
    from eeg_image_decode_tpu_torch.ops.tsconv import expand_folded_kernel
    from eeg_image_decode_tpu_torch.parallel.collectives import (
        data_parallel,
    )

    bn = GramStage1BN(inp["w"].shape[1])
    with torch.no_grad():
        bn.scale.copy_(inp["scale"])
        bn.bias.copy_(inp["bias"])
    x = inp["x2"][mesh.rows(inp["x2"].shape[0])].clone().requires_grad_(True)
    w = inp["w"].clone().requires_grad_(True)
    e = expand_folded_kernel(w, x.shape[1], inp["stride"])
    with data_parallel(mesh):
        mul, add = bn.affine(x, e, e.shape[1] // w.shape[1], True)
    (torch.stack([mul, add]) * inp["probe"]).sum().backward()
    return {"mul": mul.detach(), "add": add.detach(), "mean": bn.mean,
            "var": bn.var, "dx": x.grad, "dw": w.grad}


def main() -> None:
    rank, world, rdv, directory = (int(sys.argv[1]), int(sys.argv[2]),
                                   sys.argv[3], sys.argv[4])
    multihost.initialize(device="cpu", init_method="file://" + rdv,
                         rank=rank, world_size=world)
    mesh = _mesh()
    for case in sys.argv[5:]:
        inp = torch.load(os.path.join(directory, f"{case}.pt"),
                         weights_only=False)
        out = globals()[f"case_{case}"](inp, mesh)
        torch.save(out, os.path.join(directory, f"{case}_r{rank}.pt"))


if __name__ == "__main__":
    main()
