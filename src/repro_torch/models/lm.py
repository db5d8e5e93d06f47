"""The LM families of the port: init, the training loss, full-sequence
logits, and the serving path (prefill and decode over KV and SSM caches).

The port of the JAX package's ``models/lm.py``, its five families:

* ``dense``  — GQA transformer (yi-34b, chatglm3, qwen2, glm4, pixtral's
               backbone);
* ``moe``    — GQA transformer with an MoE FFN (llama4-scout, moonshot);
* ``ssm``    — Mamba2 / SSD stack (mamba2-370m);
* ``hybrid`` — Mamba2 backbone with ONE shared attention+MLP block applied
               after every full segment of ``attn_every`` layers (zamba2-7b);
* ``encdec`` — a bidirectional encoder over the frontend's ``src_emb``
               and a decoder with cross-attention (seamless-m4t).

The JAX package scans stacked layer pytrees; the port holds the layers in
``nn.ModuleList``s (named ``layers.<i>.…`` and, for the encoder,
``enc_layers.<i>.…``; :func:`repro_torch.convert.lm_params_from_jax`
unstacks a JAX tree).  The
JAX package's sharding annotations (``parallel.shard``) are the identity
on one device and have no counterpart.  With ``quant_backend="pallas"``
every quantized linear runs K1 on both operands and K3
(:func:`repro_torch.kernels.lowbit_matmul_qd`), in training for its
forward, data-gradient and weight-gradient GEMM alike.

Training (:func:`lm_loss`) rounds stochastically whenever it is given a
key: the stack's key is ``fold_in(key, 2)``, layer ``i``'s ``fold_in(that,
i)`` (the hybrid's shared block ``10_000 + si``), and every linear folds
in its site tag, as in the JAX package (an MoE layer's experts
``fold_in(layer key, 1000)``, a decoder layer's cross-attention
``fold_in(layer key, 500)``; the encoder runs on ``fold_in(key, 1)``, its
layer ``i`` on ``fold_in(that, 20_000 + i)``).  With ``cfg.remat ==
"full"`` each dense, MoE, Mamba2, encoder or decoder layer runs under
``torch.utils.checkpoint``, its forward computed again in the backward
pass, as JAX remats its layer scans; the rounding streams are seeded per
(key, site, operand), so the recomputed forward draws the same bytes.  The
hybrid's shared block is not remat'd, as in JAX.  Serving rounds to
nearest (no key).  As in the JAX package, the encoder-decoder's
cross-attention K/V are quantized in training (``wk``/``wv`` of the
encoder's output) and not at prefill, which computes them once,
unquantized, into the cache.

A cache is a dict of tensors plus ``"pos"`` (a Python int, the next
position).  :func:`decode_step` writes the KV caches in place (the JAX
engine donates them) and returns a new dict with the new SSM states.  As
in the JAX package, :func:`cache_spec` lists the compute dtype for the
conv state, which only the zero state of a fresh cache keeps: prefill and
decode return the fp32 rows of the projection, as JAX's layer scan does.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.core import QuantConfig, fold_in
from repro_torch.runtime import resolve_device

from . import nn as L
from .mamba2 import Mamba2Block
from .moe import MoE
from .transformer import MLP, Attention, Block, norm_init

__all__ = ["LM", "MoEBlock", "XDecBlock", "cache_spec", "decode_step", "embed", "gather_view",
           "init_cache", "init_lm", "lm_loss", "logits_fn", "prefill", "serve_qcfg"]

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec")
SRC_LEN = 4096  # encoder positions a cache holds unless told otherwise


class MoEBlock(nn.Module):
    """Pre-norm block with an MoE FFN: ``ln1``, ``attn``, ``ln2``, ``moe``;
    returns ``(x, aux)``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.ln1 = norm_init(cfg)
        self.attn = Attention(cfg)
        self.ln2 = norm_init(cfg)
        self.moe = MoE(cfg)

    def init_(self, generator: torch.Generator) -> None:
        self.attn.init_(generator)
        self.moe.init_(generator)

    def forward(self, x, qcfg, key, *, cache=None, cache_pos: int = 0, window=None):
        h = self.attn(self.ln1(x), qcfg, key, cache=cache, cache_pos=cache_pos, window=window)
        x = x + h.to(x.dtype)
        h, aux = self.moe(self.ln2(x), qcfg, fold_in(key, 1000))
        return x + h.to(x.dtype), aux


class XDecBlock(nn.Module):
    """The encoder-decoder's decoder layer: ``ln1``, causal self-``attn``,
    ``lnx``, ``xattn`` (cross-attention over the encoder's output
    ``memory``, or over its precomputed K/V ``cross_cache``), ``ln2``,
    ``mlp``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.ln1 = norm_init(cfg)
        self.attn = Attention(cfg)
        self.lnx = norm_init(cfg)
        self.xattn = Attention(cfg)
        self.ln2 = norm_init(cfg)
        self.mlp = MLP(cfg)

    def init_(self, generator: torch.Generator) -> None:
        self.attn.init_(generator)
        self.xattn.init_(generator)
        self.mlp.init_(generator)

    def forward(self, x, qcfg, key, *, memory=None, cache=None, cross_cache=None,
                cache_pos: int = 0):
        h = self.attn(self.ln1(x), qcfg, key, cache=cache, cache_pos=cache_pos)
        x = x + h.to(x.dtype)
        if cross_cache is not None:
            h = self.xattn(self.lnx(x), qcfg, fold_in(key, 500), cross_cache=cross_cache)
        else:
            h = self.xattn(self.lnx(x), qcfg, fold_in(key, 500), kv=memory, causal=False)
        x = x + h.to(x.dtype)
        h = self.mlp(self.ln2(x), qcfg, key)
        return x + h.to(x.dtype)


_LAYERS = {"dense": Block, "moe": MoEBlock, "ssm": Mamba2Block, "hybrid": Mamba2Block,
           "encdec": XDecBlock}


class LM(nn.Module):
    """Parameters of one LM: ``emb`` (vocab, d), ``final_norm``, ``lm_head``
    (vocab, d; absent when tied), ``frontend_proj`` (with a frontend),
    ``layers``, for ``hybrid`` the ``shared_attn`` block and for
    ``encdec`` the encoder's ``enc_layers``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown LM family {cfg.family!r}; expected one of {FAMILIES}")
        self.cfg = cfg
        d = cfg.d_model
        self.emb = nn.Parameter(torch.empty(cfg.vocab, d))
        self.final_norm = norm_init(cfg)
        self.lm_head = None if cfg.tie_embeddings else nn.Parameter(torch.empty(cfg.vocab, d))
        self.frontend_proj = (L.Linear(cfg.frontend_dim, d, bias=True)
                              if cfg.frontend != "none" else None)
        self.layers = nn.ModuleList(_LAYERS[cfg.family](cfg) for _ in range(cfg.n_layers))
        self.shared_attn = Block(cfg) if cfg.family == "hybrid" else None
        self.enc_layers = (nn.ModuleList(Block(cfg) for _ in range(cfg.enc_layers))
                           if cfg.family == "encdec" else None)

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        """The JAX package's ``init_lm`` distributions (not its stream)."""
        self.emb.copy_(L.trunc_normal(self.emb.shape, 0.02, generator, self.emb.device))
        if self.lm_head is not None:
            self.lm_head.copy_(L.trunc_normal(self.lm_head.shape, 0.02, generator,
                                              self.lm_head.device))
        if self.frontend_proj is not None:
            self.frontend_proj.init_(generator)
        for layer in self.layers:
            layer.init_(generator)
        if self.shared_attn is not None:
            self.shared_attn.init_(generator)
        for layer in self.enc_layers or ():
            layer.init_(generator)

    def forward(self, batch: dict, window: int | None = None) -> torch.Tensor:
        """Teacher-forced logits of every position, fp32 (B, S, vocab), on
        the config's quantization with nearest rounding; ``window`` bounds
        the attention (the hybrid's ring buffer in a full-sequence pass)."""
        cfg, qcfg = self.cfg, serve_qcfg(self.cfg)
        x = embed(self, batch)
        if cfg.family in ("dense", "moe"):
            x, _ = _dense(self, x, qcfg, None, window=window)
        elif cfg.family == "ssm":
            x, _ = _ssm(self, x, qcfg, None)
        elif cfg.family == "hybrid":
            x, _ = _hybrid(self, x, qcfg, None, window=window)
        else:
            x = _xdec(self, x, qcfg, None, _encoder(self, batch, qcfg, None))
        return logits_fn(self, self.final_norm(x))


def init_lm(cfg: ModelConfig, seed: int = 0, device: str | torch.device = "cuda") -> LM:
    """A model of ``cfg`` with fp32 random weights from ``seed``, made on
    ``device`` (CUDA unless the caller asks for the CPU) by a generator
    there: one seed gives other weights on the card than on the CPU; move
    a model with ``.to`` to compare the two."""
    device = resolve_device(device)
    with torch.device(device):
        model = LM(cfg)
    model.init_(torch.Generator(device=device).manual_seed(seed))
    return model


# ===========================================================================
# embedding / head
# ===========================================================================
def embed(model: LM, batch: dict) -> torch.Tensor:
    """Token embeddings in the compute dtype; with a frontend, its
    projected embeddings (unquantized: the first layer) replace the first
    positions."""
    cfg = model.cfg
    cdt = torch_dtype(cfg.compute_dtype)
    x = model.emb[batch["tokens"]].to(cdt)
    if cfg.frontend != "none" and "frontend_emb" in batch:
        fe = model.frontend_proj(batch["frontend_emb"].to(cdt))
        f = fe.shape[1]
        x = torch.cat([fe.to(cdt), x[:, f:]], dim=1)
    return x


def logits_fn(model: LM, x: torch.Tensor) -> torch.Tensor:
    """``x @ head.T`` -> fp32, unquantized (the last layer, paper Sec.
    VI-A): the head rounded to ``x``'s dtype, the products summed in fp32
    (the JAX package's ``preferred_element_type=float32``)."""
    head = model.emb if model.cfg.tie_embeddings else model.lm_head
    return x.float() @ head.to(x.dtype).float().t()


# ===========================================================================
# family bodies
# ===========================================================================
def _layer(layer: nn.Module, view: dict | None, remat: bool, *args, **kwargs):
    """``layer(*args, **kwargs)``: on the cast parameters of ``view`` (by
    name within the layer; :func:`gather_view`) where given, and under
    activation checkpointing when ``remat``."""
    fn = layer
    if view is not None:
        def fn(*a, **k):
            return torch.func.functional_call(layer, view, a, k)
    if remat:
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return fn(*args, **kwargs)


def _sub(view: dict | None, prefix: str) -> dict | None:
    """The entries of ``view`` under ``prefix``, named within it."""
    if view is None:
        return None
    return {k[len(prefix):]: v for k, v in view.items() if k.startswith(prefix)}


def _dense(model: LM, x, qcfg, key, *, caches=None, cache_pos: int = 0, window=None,
           view=None, remat=False):
    """The dense or MoE stack, threading the stacked KV caches ``(k, v)``
    (L, B, M, KV, hd) when given (written in place); returns ``(x, aux)``,
    aux the mean of the MoE layers' load-balance losses (0 for dense)."""
    moe = model.cfg.family == "moe"  # a MoEBlock returns (x, aux)
    auxes = []
    for i, layer in enumerate(model.layers):
        cache = (caches[0][i], caches[1][i]) if caches is not None else None
        x = _layer(layer, _sub(view, f"layers.{i}."), remat, x, qcfg, fold_in(key, i),
                   cache=cache, cache_pos=cache_pos, window=window)
        if moe:
            x, aux = x
            auxes.append(aux)
    if not moe:
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    return x, torch.stack(auxes).mean()


def _encoder(model: LM, batch: dict, qcfg, key, *, view=None, remat=False):
    """The encoder: its bidirectional blocks over ``frontend_proj(src_emb)``
    (unquantized: the first layer), layer ``i`` on ``fold_in(key, 20_000 +
    i)``."""
    cdt = torch_dtype(model.cfg.compute_dtype)
    x = model.frontend_proj(batch["src_emb"].to(cdt)).to(cdt)
    for i, layer in enumerate(model.enc_layers):
        x = _layer(layer, _sub(view, f"enc_layers.{i}."), remat, x, qcfg,
                   fold_in(key, 20_000 + i), causal=False)
    return x


def _xdec(model: LM, x, qcfg, key, memory=None, *, caches=None, cross=None,
          cache_pos: int = 0, view=None, remat=False):
    """The decoder stack: cross-attention over ``memory`` (the encoder's
    output) or, serving, over the stacked cross K/V ``cross`` (L, B, Sk,
    KV, hd) x2; self-attention threads the KV caches ``caches`` when
    given."""
    for i, layer in enumerate(model.layers):
        cache = (caches[0][i], caches[1][i]) if caches is not None else None
        xc = (cross[0][i], cross[1][i]) if cross is not None else None
        x = _layer(layer, _sub(view, f"layers.{i}."), remat, x, qcfg, fold_in(key, i),
                   memory=memory, cache=cache, cross_cache=xc, cache_pos=cache_pos)
    return x


def _ssm(model: LM, x, qcfg, key, *, states=None, view=None, remat=False):
    """The Mamba2 stack; with ``states`` (conv (L, B, K-1, C), ssm (L, B, H,
    P, N)) returns the new ones."""
    conv, ssm = [], []
    for i, layer in enumerate(model.layers):
        st = (states[0][i], states[1][i]) if states is not None else None
        x, ns = _layer(layer, _sub(view, f"layers.{i}."), remat, x, qcfg, fold_in(key, i), st)
        if states is not None:
            conv.append(ns[0])
            ssm.append(ns[1])
    return x, ((torch.stack(conv), torch.stack(ssm)) if states is not None else None)


def _hybrid(model: LM, x, qcfg, key, *, states=None, attn_caches=None, cache_pos: int = 0,
            kv_valid=None, positions=None, window=None, view=None, remat=False):
    """Zamba2: Mamba2 segments of ``attn_every`` layers, the shared block
    after every full segment (instance ``si`` uses KV cache ``si``), then the
    tail of ``n_layers % attn_every`` layers.  KV caches are written in
    place; with ``states``, returns the new SSM states.  ``remat`` applies
    to the Mamba2 layers, never to the shared block."""
    cfg = model.cfg
    e, n = cfg.attn_every, cfg.n_layers
    conv, ssm = [], []
    for i, layer in enumerate(model.layers):
        st = (states[0][i], states[1][i]) if states is not None else None
        x, ns = _layer(layer, _sub(view, f"layers.{i}."), remat, x, qcfg, fold_in(key, i), st)
        if states is not None:
            conv.append(ns[0])
            ssm.append(ns[1])
        si, last = divmod(i + 1, e)
        if last == 0 and i < (n // e) * e:  # the end of full segment si - 1
            si -= 1
            cache = ((attn_caches[0][si], attn_caches[1][si])
                     if attn_caches is not None else None)
            x = _layer(model.shared_attn, _sub(view, "shared_attn."), False, x, qcfg,
                       fold_in(key, 10_000 + si), cache=cache, cache_pos=cache_pos,
                       kv_valid=kv_valid, positions=positions, window=window)
    return x, ((torch.stack(conv), torch.stack(ssm)) if states is not None else None)


# ===========================================================================
# train loss
# ===========================================================================
def gather_view(model: LM) -> dict[str, torch.Tensor] | None:
    """The layer parameters (``layers.*``, ``enc_layers.*``,
    ``shared_attn.*``) cast to
    ``cfg.param_gather_dtype`` inside the forward, or None when that is
    float32.  The fp32 masters stay the parameters (and get the
    gradients, through the cast): in the JAX package the cast lets FSDP
    gather 2-byte weights; on one card it changes only the numbers the
    layers see."""
    cfg = model.cfg
    if cfg.param_gather_dtype == "float32":
        return None
    dt = torch_dtype(cfg.param_gather_dtype)
    return {name: (p.to(dt) if p.dtype == torch.float32 else p)
            for name, p in model.named_parameters()
            if name.startswith(("layers.", "enc_layers.", "shared_attn."))}


def lm_loss(model: LM, batch: dict, key: int | None = None
            ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Causal LM loss of ``batch["tokens"]`` (B, S) (with a frontend, its
    ``frontend_emb`` (B, F, frontend_dim) replaces the first positions,
    which are not trained on; the encoder-decoder's encoder reads
    ``src_emb`` (B, S_src, frontend_dim), and every target position is
    trained on): ``(ce + 0.01 * aux, {"ce", "aux"})``, fp32 scalars, aux
    the MoE layers' mean load-balance loss (0 for the other families).
    ``cfg.qcfg()`` quantizes the linears, rounding stochastically from
    ``key`` (to nearest when it is None)."""
    cfg = model.cfg
    if cfg.remat not in ("full", "none"):
        raise NotImplementedError(
            f"remat {cfg.remat!r} (JAX's dots_with_no_batch_dims_saveable policy) is not "
            f"ported yet (ROADMAP queue 1); the port remats 'full' or 'none'")
    qcfg, view, remat = cfg.qcfg(), gather_view(model), cfg.remat == "full"
    kw = dict(view=view, remat=remat)
    memory = (_encoder(model, batch, qcfg, fold_in(key, 1), **kw)
              if cfg.family == "encdec" else None)
    x = embed(model, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in ("dense", "moe"):
        x, aux = _dense(model, x, qcfg, fold_in(key, 2), **kw)
    elif cfg.family == "ssm":
        x, _ = _ssm(model, x, qcfg, fold_in(key, 2), **kw)
    elif cfg.family == "hybrid":
        x, _ = _hybrid(model, x, qcfg, fold_in(key, 2), **kw)
    else:
        x = _xdec(model, x, qcfg, fold_in(key, 2), memory, **kw)
    logits = logits_fn(model, model.final_norm(x))

    targets = batch["tokens"][:, 1:]
    lg = logits[:, :-1].float()
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, targets[..., None].long())[..., 0]
    mask = torch.ones(targets.shape, dtype=torch.float32, device=x.device)
    if cfg.frontend != "none" and cfg.frontend_len and cfg.family != "encdec":
        # no training on the frontend's positions (the encoder-decoder's
        # frontend feeds its encoder, not these positions)
        pos = torch.arange(targets.shape[1], device=x.device)
        mask = mask * (pos[None, :] >= cfg.frontend_len)
    ce = torch.sum((lse - ll) * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


# ===========================================================================
# caches / serving
# ===========================================================================
def cache_spec(cfg: ModelConfig, batch: int, max_len: int, src_len: int = SRC_LEN
               ) -> dict[str, tuple]:
    """``{name: (shape, dtype)}`` of the decode cache's tensors; the
    encoder-decoder's also holds the cross-attention K/V ``xk``/``xv`` of
    ``src_len`` encoder positions."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown LM family {cfg.family!r}; expected one of {FAMILIES}")
    dt = torch_dtype(cfg.compute_dtype)
    hd, kv, n = cfg.hd, cfg.n_kv_heads, cfg.n_layers
    if cfg.family in ("dense", "moe", "encdec"):
        spec = {"k": ((n, batch, max_len, kv, hd), dt), "v": ((n, batch, max_len, kv, hd), dt)}
        if cfg.family == "encdec":
            spec.update(xk=((n, batch, src_len, kv, hd), dt), xv=((n, batch, src_len, kv, hd), dt))
        return spec
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    spec = {"conv": ((n, batch, cfg.ssm_conv - 1, conv_dim), dt),
            "ssm": ((n, batch, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state), torch.float32)}
    if cfg.family == "hybrid":
        alen = min(max_len, cfg.window) if cfg.window else max_len
        shape = (n // cfg.attn_every, batch, alen, kv, hd)
        spec.update(ak=(shape, dt), av=(shape, dt))
    return spec


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: str | torch.device = "cuda", src_len: int = SRC_LEN) -> dict:
    """A zero cache at position 0 on ``device``."""
    cache: dict = {name: torch.zeros(shape, dtype=dt, device=device)
                   for name, (shape, dt) in cache_spec(cfg, batch, max_len, src_len).items()}
    cache["pos"] = 0
    return cache


def serve_qcfg(cfg: ModelConfig) -> QuantConfig | None:
    """The quantized linears' config at inference: ``cfg.qcfg()`` with
    nearest rounding (no stochastic rounding)."""
    qcfg = cfg.qcfg()
    return None if qcfg is None else dataclasses.replace(qcfg, stochastic=False)


@torch.no_grad()
def prefill(model: LM, batch: dict, max_len: int) -> tuple[torch.Tensor, dict]:
    """Run the whole prompt ``batch["tokens"]`` (B, S), filling a new cache
    of ``max_len`` positions; returns ``(logits of the last position fp32
    (B, vocab), cache)``.  The encoder-decoder encodes ``batch["src_emb"]``
    and puts each decoder layer's cross K/V of it, unquantized, into the
    cache."""
    cfg, qcfg = model.cfg, serve_qcfg(model.cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    src_len = batch["src_emb"].shape[1] if "src_emb" in batch else SRC_LEN
    cache = init_cache(cfg, b, max_len, tokens.device, src_len)
    x = embed(model, batch)
    if cfg.family in ("dense", "moe"):
        x, _ = _dense(model, x, qcfg, None, caches=(cache["k"], cache["v"]))
    elif cfg.family == "ssm":
        x, (cache["conv"], cache["ssm"]) = _ssm(model, x, qcfg, None,
                                                 states=(cache["conv"], cache["ssm"]))
    elif cfg.family == "hybrid":
        x, (cache["conv"], cache["ssm"]) = _hybrid(
            model, x, qcfg, None, states=(cache["conv"], cache["ssm"]),
            attn_caches=(cache["ak"], cache["av"]))
    else:
        memory = _encoder(model, batch, qcfg, None)
        kv, hd = cfg.n_kv_heads, cfg.hd
        for i, layer in enumerate(model.layers):  # the cross K/V, once, unquantized
            cache["xk"][i] = layer.xattn.wk(memory).reshape(b, -1, kv, hd)
            cache["xv"][i] = layer.xattn.wv(memory).reshape(b, -1, kv, hd)
        x = _xdec(model, x, qcfg, None, caches=(cache["k"], cache["v"]),
                  cross=(cache["xk"], cache["xv"]))
    cache["pos"] = s
    return logits_fn(model, model.final_norm(x[:, -1:]))[:, 0], cache


@torch.no_grad()
def decode_step(model: LM, cache: dict, tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One serving step: ``tokens`` (B, 1) -> ``(logits fp32 (B, vocab),
    cache)``, the cache one position further."""
    cfg, qcfg = model.cfg, serve_qcfg(model.cfg)
    x = model.emb[tokens].to(torch_dtype(cfg.compute_dtype))
    pos = cache["pos"]
    new_cache = dict(cache)
    if cfg.family in ("dense", "moe"):
        x, _ = _dense(model, x, qcfg, None, caches=(cache["k"], cache["v"]), cache_pos=pos)
    elif cfg.family == "encdec":
        x = _xdec(model, x, qcfg, None, caches=(cache["k"], cache["v"]),
                  cross=(cache["xk"], cache["xv"]), cache_pos=pos)
    elif cfg.family == "ssm":
        x, (new_cache["conv"], new_cache["ssm"]) = _ssm(
            model, x, qcfg, None, states=(cache["conv"], cache["ssm"]))
    else:
        alen = cache["ak"].shape[2]
        if cfg.window:  # ring buffer: write slot pos % alen; the filled slots are valid
            wpos, kv_valid = pos % alen, min(pos + 1, alen)
            positions = torch.full((tokens.shape[0], 1), pos, device=tokens.device)
        else:
            wpos, kv_valid, positions = pos, None, None
        x, (new_cache["conv"], new_cache["ssm"]) = _hybrid(
            model, x, qcfg, None, states=(cache["conv"], cache["ssm"]),
            attn_caches=(cache["ak"], cache["av"]), cache_pos=wpos, kv_valid=kv_valid,
            positions=positions)  # the ring buffer already bounds the window
    new_cache["pos"] = pos + 1
    return logits_fn(model, model.final_norm(x))[:, 0], new_cache
