"""Fused projection head (counterpart of
``eeg_image_decode_tpu/ops/projection.py``, the ``Proj_eeg`` MLP):

    y = LayerNorm(a + Dropout(res_proj(GELU(a)))),   a = in_proj(x)

with ``a`` kept in fp32, tanh GELU and a biased-variance fp32 LayerNorm
(eps 1e-6); the output is fp32.

``fused_projection_head`` is a ``torch.autograd.Function``. For a CUDA
tensor its forward is ``csrc/projection_fwd.cu`` and its backward
``csrc/projection_bwd.cu`` (recompute on chip, dx in x's dtype, fp32
parameter gradients reduced in a fixed order, so two runs agree bit for
bit). In bfloat16 both run their products on the tensor cores and share
the forward chain of ``csrc/projection_chain.cuh`` (a and gdt, then r, then
the forward's LayerNorm row pass; :func:`projection_head_forward_chain` is
that arithmetic in plain PyTorch, for the CPU tests); in float32 they are
full-fp32 FMA loops. For a CPU tensor it runs the plain versions:
``projection_head_reference`` and ``projection_head_backward_reference``,
which follows the rounding points of the JAX backward kernel line by line.

Dropout on the residual branch, after ``res_proj``'s bias and before the
add, three modes (as in the JAX kernel):

- none;
- ``mask``: an explicit pre-scaled keep-mask (B, d_out), cast to x's dtype
  and widened to fp32 where it multiplies;
- ``dropout_p`` + ``seed``: the mask is drawn inside both kernels by the
  Philox-4x32-10 of ``csrc/philox.cuh`` (site 4; :func:`draw_keep_mask` is
  the same draw in tensor arithmetic): key (seed, global row, the call's
  first being ``sample0``), counter (column // 4, 4, 0, 0), word column % 4; keep iff
  ``bits < uint32(keep · 0xFFFFFFFF)``, value the fp32 ``1/keep``. The bits
  differ from the TPU hardware generator's; the keep rule and the purity
  are shared with it.

The model's default head (``models/layers.py::ProjectionHead`` with
``fused=False``/``'auto'``) is a different function: exact-erf GELU and the
fast-variance LayerNorm, |Δ| ≲ 1e-3 from this one, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from eeg_image_decode_tpu_torch.ops import _build
from eeg_image_decode_tpu_torch.ops.attention import _gelu_tanh_and_grad
from eeg_image_decode_tpu_torch.ops.philox import keep_mask, keep_rule

PARAM_ORDER = ("wi", "bi", "wr", "br", "ln_s", "ln_b")
#: the head's site id in the Philox counter (0-3: the attention layer's)
SITE = 4
_MODES = {"none": 0, "mask": 1, "seed": 2}
_LAUNCH_NAMES = {"none": "projection_fwd", "mask": "projection_fwd_masks",
                 "seed": "projection_fwd_seed"}


def draw_keep_mask(seed, batch: int, d_out: int, dropout_p: float, *,
                   row0: int = 0, device=None) -> torch.Tensor:
    """The fp32 keep-mask (batch, d_out), values 0 or 1/keep, that the
    seed-mode kernels draw for rows ``row0 … row0+batch−1``."""
    rows = torch.arange(row0, row0 + batch, dtype=torch.int64, device=device)
    return keep_mask(seed, rows, SITE, d_out, dropout_p)


# ——— plain versions ———


def projection_head_reference(x: torch.Tensor, params: dict,
                              mask: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """Plain PyTorch head: (B, d_in) → (B, d_out) fp32, the kernel's math.
    ``mask``: the pre-scaled keep-mask (B, d_out), applied in fp32 after
    ``res_proj``'s bias."""
    dt = x.dtype
    # products of dtype values, accumulated in fp32 (exact for bf16 inputs)
    a = x.float() @ params["wi"].to(dt).float() + params["bi"].float()
    g = F.gelu(a, approximate="tanh").to(dt)
    z = g.float() @ params["wr"].to(dt).float() + params["br"].float()
    if mask is not None:
        z = z * mask.float()
    r = a + z
    mu = r.mean(-1, keepdim=True)
    var = r.var(-1, keepdim=True, correction=0)
    xhat = (r - mu) * torch.rsqrt(var + 1e-6)
    return xhat * params["ln_s"].float() + params["ln_b"].float()


def projection_head_forward_chain(x: torch.Tensor, params: dict,
                                  mask: torch.Tensor | None = None
                                  ) -> torch.Tensor:
    """The forward the way the bfloat16 kernels run it, launch by launch,
    in plain PyTorch: (1) ``a = x Wi + bi`` in fp32 and ``gdt =
    rnd(gelu_tanh(a))``; (2) ``r = a + (gdt Wr + br)·m`` in fp32; (3) the
    row pass: the mean, then the biased variance about it, eps 1e-6, then
    ``(r − mu)·inv·ln_s + ln_b``. Products of x-dtype operands, fp32 sums.
    For the CPU tests; the wrapper's plain version is
    :func:`projection_head_reference`."""
    dt = x.dtype
    p = {k: params[k].to(dt).float() for k in PARAM_ORDER}
    a = x.float() @ p["wi"] + p["bi"]                           # launch 1
    gdt = F.gelu(a, approximate="tanh").to(dt)
    z = gdt.float() @ p["wr"] + p["br"]                         # launch 2
    if mask is not None:  # as given: x's dtype in mask mode, fp32 in seed mode
        z = z * mask.float()
    r = a + z
    mu = r.mean(-1, keepdim=True)                               # launch 3
    var = (r - mu).square().mean(-1, keepdim=True)
    return (r - mu) * torch.rsqrt(var + 1e-6) * p["ln_s"] + p["ln_b"]


def projection_head_backward_reference(
        x: torch.Tensor, params: dict, g: torch.Tensor,
        mask: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """Plain backward of the head, following the JAX ``_bwd_kernel`` line by
    line: recompute the forward, then the LayerNorm backward, ``d_z`` and
    ``d_a`` rounded to x's dtype for the four products (fp32 accumulation)
    while the two bias gradients sum the fp32 values. ``mask`` is used as
    given, in fp32 (the launcher hands mask mode the x-dtype mask, seed
    mode the fp32 draw).

    Returns dx in x's dtype and the six parameter gradients in fp32."""
    dt = x.dtype
    p = {k: params[k].to(dt).float() for k in PARAM_ORDER}

    def mm(a, b):  # operands in dt, fp32 accumulation
        return torch.matmul(a.to(dt).float(), b.to(dt).float())

    # ——— forward recompute ———
    a = mm(x, p["wi"]) + p["bi"]
    gelu, dgelu = _gelu_tanh_and_grad(a)
    gdt = gelu.to(dt)
    z = mm(gdt, p["wr"]) + p["br"]
    m = None if mask is None else mask.float()
    if m is not None:
        z = z * m
    r = a + z
    mu = r.mean(-1, keepdim=True)
    var = (r - mu).square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + 1e-6)
    xhat = (r - mu) * inv

    # ——— backward ———
    g_out = g.float()
    grads = {"ln_s": (g_out * xhat).sum(0), "ln_b": g_out.sum(0)}
    gxh = g_out * p["ln_s"]
    d_r = (gxh - gxh.mean(-1, keepdim=True)
           - xhat * (gxh * xhat).mean(-1, keepdim=True)) * inv
    d_z = d_r * m if m is not None else d_r
    grads["wr"] = mm(gdt.T, d_z)
    grads["br"] = d_z.sum(0)
    d_g = mm(d_z, p["wr"].T)
    d_a = d_r + d_g * dgelu
    grads["wi"] = mm(x.T, d_a)
    grads["bi"] = d_a.sum(0)
    dx = mm(d_a, p["wi"].T).to(dt)
    return dx, grads


# ——— the kernels ———


class _Dropout:
    """How a call drops out: mode "none", "mask" (one tensor in x's dtype)
    or "seed" (an int32 seed, a Python int or a one-element tensor, the
    rate, and ``sample0``, the global index of the call's first row)."""

    def __init__(self, mask=None, dropout_p: float = 0.0, seed=None,
                 sample0: int = 0):
        self.mask = mask
        self.p = dropout_p
        self.seed = seed
        self.sample0 = int(sample0)
        if mask is not None:
            self.mode = "mask"
        elif dropout_p > 0.0 and seed is not None:
            self.mode = "seed"
        else:
            self.mode = "none"

    def plain_mask(self, x: torch.Tensor, d_out: int):
        """The mask the plain versions apply: as given, or drawn."""
        if self.mode == "seed":
            return draw_keep_mask(self.seed, x.shape[0], d_out, self.p,
                                  row0=self.sample0, device=x.device)
        return self.mask

    def c_args(self, x: torch.Tensor):
        """(mode, mask pointer, seed pointer, threshold, keep value,
        sample0) for the launchers; keeps the device seed alive on
        ``self``."""
        mask_ptr, seed_ptr, thresh, value = 0, 0, 0, 0.0
        if self.mode == "mask":
            mask_ptr = self.mask.data_ptr()
        elif self.mode == "seed":
            if not torch.is_tensor(self.seed):
                self.seed = torch.tensor([int(self.seed)], dtype=torch.int32)
            self.seed = self.seed.to(x.device, torch.int32).reshape(1)
            seed_ptr = self.seed.data_ptr()
            thresh, value = keep_rule(self.p)
        return (_MODES[self.mode], mask_ptr, seed_ptr, thresh, value,
                self.sample0)


def _check_shapes(x, p, mask):
    if x.dim() != 2:
        raise ValueError(f"x has shape {tuple(x.shape)}, expected (B, d_in)")
    B, d_in = x.shape
    d_out = p["wi"].shape[1]
    shapes = {"wi": (d_in, d_out), "bi": (d_out,), "wr": (d_out, d_out),
              "br": (d_out,), "ln_s": (d_out,), "ln_b": (d_out,)}
    for k, shape in shapes.items():
        if tuple(p[k].shape) != shape:
            raise ValueError(f"{k} has shape {tuple(p[k].shape)}, "
                             f"expected {shape}")
    if mask is not None and tuple(mask.shape) != (B, d_out):
        raise ValueError(f"mask has shape {tuple(mask.shape)}, expected "
                         f"{(B, d_out)}")
    return B, d_in, d_out


def _cuda_args(name, x, p, drop):
    extra = {"mask": drop.mask} if drop.mask is not None else {}
    _build.check_cuda_args(name, x, {**p, **extra})


def _forward(x, p, drop: _Dropout) -> torch.Tensor:
    if x.device.type == "cpu":
        return projection_head_reference(
            x, p, drop.plain_mask(x, p["wi"].shape[1]))
    if x.device.type != "cuda":
        raise ValueError(f"fused_projection_head: no kernel for {x.device}")
    B, d_in, d_out = _check_shapes(x, p, drop.mask)
    _cuda_args("fused_projection_head", x, p, drop)
    code = _build.DTYPE_CODES[x.dtype]
    lib = _build.lib()
    ws_bytes = lib.eid_projection_fwd_workspace(code, B, d_in, d_out)
    if ws_bytes < 0:
        raise ValueError(f"projection_fwd ({forward_design(x.dtype)}): "
                         f"shapes (d_in {d_in}, d_out {d_out}) do not fit "
                         "the kernel")
    # the bfloat16 design's a (fp32) and gdt between its launches
    ws = torch.empty(max(ws_bytes, 1), dtype=torch.uint8, device=x.device)
    out = torch.empty((B, d_out), dtype=torch.float32, device=x.device)
    weights = _build.pointer_array([p[k] for k in PARAM_ORDER])
    rc = lib.eid_projection_fwd(
        code, x.data_ptr(), weights, out.data_ptr(), ws.data_ptr(), B, d_in,
        d_out, *drop.c_args(x), _build.stream_of(x))
    name = _LAUNCH_NAMES[drop.mode]
    _build.check(rc, name)
    _build.LAUNCHES[name] += 1
    return out


def _backward(x, p, g, drop: _Dropout):
    """(dx, fp32 gradients); p in x's dtype."""
    d_out = p["wi"].shape[1]
    if x.device.type == "cpu":
        return projection_head_backward_reference(
            x, p, g, drop.plain_mask(x, d_out))
    B, d_in, d_out = _check_shapes(x, p, drop.mask)
    if tuple(g.shape) != (B, d_out):
        raise ValueError(f"g has shape {tuple(g.shape)}, expected "
                         f"{(B, d_out)}")
    g = g.to(x.device, torch.float32).contiguous()
    _cuda_args("fused_projection_head backward", x, p, drop)
    code = _build.DTYPE_CODES[x.dtype]
    lib = _build.lib()
    ws_bytes = lib.eid_projection_bwd_workspace(code, B, d_in, d_out)
    if ws_bytes < 0:
        raise ValueError(f"projection_bwd: shapes (d_in {d_in}, d_out "
                         f"{d_out}) do not fit the kernel")
    ws = torch.empty(max(ws_bytes, 1), dtype=torch.uint8, device=x.device)
    dx = torch.empty_like(x)
    grads = _FlatGrads(
        torch.empty(d_in * d_out + d_out * d_out + 4 * d_out,
                    dtype=torch.float32, device=x.device), d_in, d_out)
    # the float32 design reads contiguous transposed copies of the two
    # weights; the bfloat16 design reads Wi and Wr as they lie
    transposed = ([p["wi"].t().contiguous(), p["wr"].t().contiguous()]
                  if x.dtype == torch.float32 else [])
    wt_ptrs = [t.data_ptr() for t in transposed] or [0, 0]
    weights = _build.pointer_array([p[k] for k in PARAM_ORDER])
    # dWi, dWr and the vector [dbi dbr dln_s dln_b], which starts at dbi
    outs = _build.pointer_array([grads["wi"], grads["wr"], grads["bi"]])
    rc = lib.eid_projection_bwd(
        code, x.data_ptr(), g.data_ptr(), weights, *wt_ptrs,
        dx.data_ptr(), outs, ws.data_ptr(), B, d_in, d_out,
        *drop.c_args(x), _build.stream_of(x))
    _build.check(rc, "projection_bwd")
    _build.LAUNCHES["projection_bwd"] += 1
    return dx, grads


class _FlatGrads(dict):
    """The six fp32 gradients as views of the launcher's one output buffer,
    dWi | dWr | dbi dbr dln_s dln_b, so that one launch casts them all."""

    def __init__(self, flat: torch.Tensor, d_in: int, d_out: int):
        n_wi, n_wr = d_in * d_out, d_out * d_out
        super().__init__(wi=flat[:n_wi].view(d_in, d_out),
                         wr=flat[n_wi:n_wi + n_wr].view(d_out, d_out))
        vec = flat[n_wi + n_wr:]
        for i, k in enumerate(("bi", "br", "ln_s", "ln_b")):
            self[k] = vec[i * d_out:(i + 1) * d_out]
        self.flat, self.dims = flat, (d_in, d_out)

    def to(self, dtype: torch.dtype) -> "_FlatGrads":
        return _FlatGrads(self.flat.to(dtype), *self.dims)


def forward_design(dtype: torch.dtype) -> str:
    """The design the forward launcher takes for ``dtype``: ``"mma_bf16"``
    (tensor cores) or ``"fma_fp32"`` (full-fp32 FMA products)."""
    return _build.lib().eid_projection_fwd_design(
        _build.DTYPE_CODES[dtype]).decode()


def backward_design(dtype: torch.dtype) -> str:
    """The design the backward launcher takes for ``dtype``: ``"mma_bf16"``
    (tensor cores) or ``"fma_fp32"`` (full-fp32 FMA products)."""
    return _build.lib().eid_projection_bwd_design(
        _build.DTYPE_CODES[dtype]).decode()


class _ProjectionHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, drop, *flat):
        ctx.drop = drop
        ctx.save_for_backward(x, *flat)
        return _forward(x, dict(zip(PARAM_ORDER, flat)), drop)

    @staticmethod
    def backward(ctx, g):
        x, *flat = ctx.saved_tensors
        p = dict(zip(PARAM_ORDER, flat))
        dx, grads = _backward(x, p, g, ctx.drop)
        # each gradient in the dtype of the parameter passed in (x's dtype),
        # as the JAX launcher returns them
        if isinstance(grads, _FlatGrads):
            grads = grads.to(x.dtype)
        return (dx, None,
                *[grads[k].to(p[k].dtype).contiguous() for k in PARAM_ORDER])


def fused_projection_head(x: torch.Tensor, params: dict,
                          mask: torch.Tensor | None = None,
                          dropout_p: float = 0.0, seed=None,
                          sample0: int = 0) -> torch.Tensor:
    """Fused head: (B, d_in) → (B, d_out) float32, differentiable.

    ``params``: wi (d_in, d_out), bi, wr (d_out, d_out), br, ln_s, ln_b in
    the JAX layout. They are cast to x's dtype, as the JAX model hands them
    to its launcher, and their gradients come back through that cast (in
    bf16 they are rounded to bf16 first, as JAX's are). ``mask`` (B, d_out),
    a pre-scaled keep-mask, selects mask mode; ``dropout_p > 0`` with
    ``seed`` (int32, an int or a one-element tensor, which may lie on the
    card) selects seed mode; ``sample0`` is then the global index of x's
    first row, so a data-parallel rank holding rows r·B … r·B + B − 1 of
    the batch draws what one call over the whole batch draws for them. A
    CPU tensor runs the plain versions; a CUDA tensor launches the kernels
    (float32 or bfloat16) or raises."""
    dt = x.dtype
    flat = [params[k].to(dt).contiguous() for k in PARAM_ORDER]
    if mask is not None:
        mask = mask.to(x.device, dt).contiguous()
    drop = _Dropout(mask, dropout_p, seed, sample0)
    return _ProjectionHead.apply(x.contiguous(), drop, *flat)
