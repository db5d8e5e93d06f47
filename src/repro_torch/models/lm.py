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
JAX package's sharding annotations (``parallel.shard``) have no
counterpart: the port's models compute on per-rank local tensors, and
under FSDP2 (``launch.train.shard_model``) each rank runs the whole model
on its slice of the batch, the parameters gathered by FSDP2's hooks.  With ``quant_backend="pallas"``
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
(key, site, operand), so the recomputed forward draws the same bytes.
``"dots"`` is JAX's ``dots_with_no_batch_dims_saveable``: the same
layers checkpointed selectively (:func:`dots_policy`), the outputs of
matmuls without batch dims (``aten.mm``, ``aten.addmm``) saved and
everything else, attention's ``aten.bmm`` included, recomputed.  Under
``quant_backend="pallas"`` a quantized linear's GEMMs are K3 calls inside
an ``autograd.Function``, which no op-level policy sees, so they are
recomputed, as JAX's ``pallas_call`` (not a ``dot_general``) is.  The
hybrid's shared block is not remat'd, as in JAX.  Serving rounds to
nearest (no key).  As in the JAX package, the encoder-decoder's
cross-attention K/V are quantized in training (``wk``/``wv`` of the
encoder's output) and not at prefill, which computes them once,
unquantized, into the cache.

Under tensor parallelism over the ``model`` axis
(:func:`repro_torch.parallel.tensor.tensor_parallel`; every family)
``model.tp`` is set: the embedding is a vocab-parallel lookup summed over
the group, the unquantized LM head is column-parallel over vocab
(mamba2-370m's tied head too: the slice of ``emb``), and :func:`lm_loss`
takes a vocab-parallel cross-entropy, except where the model size does
not divide the vocabulary (mamba2-370m's 50280 at model 16), which stays
whole on every rank (a plain lookup, head and loss); the layers (Mamba2
layers, the hybrid's shared block, the encoder's and the decoder's blocks
with their cross-attention by the dense rules) hold their heads (an
attention with fewer units than ranks all of them), and an MoE layer
its experts (:mod:`repro_torch.models.moe`).  Serving (:func:`prefill`,
:func:`decode_step`, ``LM.forward``) a rank holds its part of the cache
(:func:`cache_spec` with ``tp``: the kv heads its query heads read, its
Mamba2 heads' conv channels and SSM states, its heads of the cross K/V),
and every rank returns the whole fp32 logits: its vocabulary slice placed
in zeros and summed over the group (:func:`whole_logits`; exact, ``x + 0
== x``).  Prefill and decode run as methods of :class:`LM`
(``LM.prefill``, ``LM.decode_step``), which ``launch.train.shard_model``
registers as FSDP2 forwards, so that a sharded model's root parameters
are gathered around them; the module's functions call them.

Under sequence parallelism (``tensor_parallel(..., seq_shard=True)``,
``model.seq_shard``) each call splits its sequence over the model group
where the axis divides it (``parallel.tensor.split_seq``; the encoder's
source frames on their own): the residual stream holds the rank's tokens
from the embedding (a split vocabulary's lookup reduce-scattered, a whole
one looked up on the rank's tokens, a frontend's prefix built whole and
sliced) to the final norm.  A split vocabulary gathers the final hidden
state and runs the head and the vocab-parallel loss as above; a whole
one runs them on the rank's tokens, the loss's token sums all-reduced
before the mean.  The loss records which sequences it split
(``model.seq_split``), which the trainer reads (``parallel.tensor.
partial_grads``).  Prefill gathers the encoder's output for the cross K/V
cache and the final hidden state for the last position's logits; the
caches hold what they hold without it.

A cache is a dict of tensors plus ``"pos"`` (a Python int, the next
position).  :func:`decode_step` writes the KV caches in place (the JAX
engine donates them) and returns a new dict with the new SSM states.  As
in the JAX package, :func:`cache_spec` lists the compute dtype for the
conv state, which only the zero state of a fresh cache keeps: prefill and
decode return the fp32 rows of the projection, as JAX's layer scan does.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.core import QuantConfig, fold_in
from repro_torch.kernels.launch import in_plain_version
from repro_torch.parallel.fsdp_wire import wire_scope
from repro_torch.parallel.tensor import (
    TAIL_RANK, copy_to_tp, gather_seq, mamba_heads, rank_heads, reduce_from_tp, scatter_seq,
    seq_unit, split_seq, vocab_parallel_ce)
from repro_torch.runtime import resolve_device

from . import nn as L
from .mamba2 import Mamba2Block
from .moe import MoE
from .transformer import MLP, Attention, Block, norm_init

__all__ = ["LM", "MoEBlock", "XDecBlock", "cache_spec", "decode_step", "embed", "gather_view",
           "init_cache", "init_lm", "lm_loss", "logits_fn", "prefill", "serve_qcfg",
           "whole_logits"]

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

    def forward(self, x, qcfg, key, *, cache=None, cache_pos: int = 0, window=None, seq=None):
        h = self.attn(self.ln1(x), qcfg, key, cache=cache, cache_pos=cache_pos, window=window,
                      seq=seq)
        x = x + h.to(x.dtype)
        h, aux = self.moe(self.ln2(x), qcfg, fold_in(key, 1000), seq=seq)
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
                cache_pos: int = 0, seq=None, mem_seq=None):
        h = self.attn(self.ln1(x), qcfg, key, cache=cache, cache_pos=cache_pos, seq=seq)
        x = x + h.to(x.dtype)
        if cross_cache is not None:
            h = self.xattn(self.lnx(x), qcfg, fold_in(key, 500), cross_cache=cross_cache,
                           seq=seq)
        else:
            h = self.xattn(self.lnx(x), qcfg, fold_in(key, 500), kv=memory, causal=False,
                           seq=seq, mem_seq=mem_seq)
        x = x + h.to(x.dtype)
        h = self.mlp(self.ln2(x), qcfg, key, seq=seq)
        return x + h.to(x.dtype)

    def cross_kv(self, memory):
        """The cross-attention's serving cache of ``memory``
        (``Attention.cross_kv``): the method a sharded layer's FSDP2 hooks
        run around (``launch.train.shard_model``)."""
        return self.xattn.cross_kv(memory)


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
        self.tp, self.tp_layout = None, {}  # tensor parallelism (parallel.tensor)
        # sequence parallelism: on, and which sequences the last loss split
        self.seq_shard, self.seq_split = False, {}

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

    def loss(self, batch: dict, key: int | None = None):
        """:func:`lm_loss` of this model: the method a sharded model's FSDP2
        hooks run around (``launch.train.shard_model``), as are
        :meth:`prefill` and :meth:`decode_step`."""
        return lm_loss(self, batch, key)

    def prefill(self, batch: dict, max_len: int) -> tuple[torch.Tensor, dict]:
        """:func:`prefill` of this model."""
        return _prefill(self, batch, max_len)

    def decode_step(self, cache: dict, tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """:func:`decode_step` of this model."""
        return _decode_step(self, cache, tokens)

    def forward(self, batch: dict, window: int | None = None) -> torch.Tensor:
        """Teacher-forced logits of every position, fp32 (B, S, vocab), on
        the config's quantization with nearest rounding; ``window`` bounds
        the attention (the hybrid's ring buffer in a full-sequence pass).
        Tensor-parallel: the whole vocabulary on every rank."""
        cfg, qcfg = self.cfg, serve_qcfg(self.cfg)
        seq, mem_seq = _seq_splits(self, batch)
        x = embed(self, batch, seq)
        if cfg.family in ("dense", "moe"):
            x, _ = _dense(self, x, qcfg, None, window=window, seq=seq)
        elif cfg.family == "ssm":
            x, _ = _ssm(self, x, qcfg, None, seq=seq)
        elif cfg.family == "hybrid":
            x, _ = _hybrid(self, x, qcfg, None, window=window, seq=seq)
        else:
            x = _xdec(self, x, qcfg, None, _encoder(self, batch, qcfg, None, seq=mem_seq),
                      seq=seq, mem_seq=mem_seq)
        h = self.final_norm(x)
        return whole_logits(self, logits_fn(self, h if seq is None else gather_seq(h, seq)))


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
def _vocab_split(model: LM) -> bool:
    """Whether the vocabulary splits over the model group (tensor-parallel,
    and the model size divides it; else ``emb`` and ``lm_head`` stay whole
    on every rank, as JAX's ``spec_for`` keeps them)."""
    return model.tp is not None and "emb" in model.tp_layout


def _vocab_start(model: LM, name: str) -> int:
    return model.tp_layout[name].bounds[model.tp.rank][0]


def embed(model: LM, batch: dict, seq=None) -> torch.Tensor:
    """Token embeddings in the compute dtype; with a frontend, its
    projected embeddings (unquantized: the first layer) replace the first
    positions.  Tensor-parallel over a split vocabulary: each rank looks up
    the tokens of its vocabulary slice, zeros for the rest, summed over the
    group.  ``seq``: this rank's tokens (the sum reduce-scattered to them; a
    whole vocabulary looks up only them; the frontend's prefix is built
    whole and sliced)."""
    cfg = model.cfg
    cdt = torch_dtype(cfg.compute_dtype)
    tokens = batch["tokens"]
    if not _vocab_split(model):
        x = model.emb[tokens if seq is None else seq.take(tokens)].to(cdt)
    else:
        v0, v = _vocab_start(model, "emb"), model.emb.shape[0]
        mine = (tokens >= v0) & (tokens < v0 + v)
        rows = model.emb[(tokens - v0).clamp(0, v - 1)]
        rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
        x = (reduce_from_tp(rows, model.tp) if seq is None else scatter_seq(rows, seq)).to(cdt)
    if cfg.frontend != "none" and "frontend_emb" in batch:
        fe = model.frontend_proj(batch["frontend_emb"].to(cdt)).to(cdt)
        a = 0 if seq is None else seq.start  # x's first position
        f = min(fe.shape[1], a + x.shape[1])
        if f > a:
            x = torch.cat([fe[:, a:f], x[:, f - a:]], dim=1)
    return x


def logits_fn(model: LM, x: torch.Tensor, seq=None) -> torch.Tensor:
    """``x @ head.T`` -> fp32, unquantized (the last layer, paper Sec.
    VI-A): the head rounded to ``x``'s dtype, the products summed in fp32
    (the JAX package's ``preferred_element_type=float32``).
    Tensor-parallel over a split vocabulary: this rank's slice of the
    logits (``seq``: of every token, ``x`` the rank's tokens, gathered)."""
    head = model.emb if model.cfg.tie_embeddings else model.lm_head
    if _vocab_split(model):
        x = copy_to_tp(x, model.tp) if seq is None else gather_seq(x, seq)
    return x.float() @ head.to(x.dtype).float().t()


def whole_logits(model: LM, logits: torch.Tensor) -> torch.Tensor:
    """The whole vocabulary's logits from :func:`logits_fn`'s: as they are
    on one device or where the vocabulary stays whole; over a split
    vocabulary, this rank's slice placed in zeros and summed over the
    model group (exact: every other rank adds zeros), so that every rank
    holds them whole."""
    if not _vocab_split(model):
        return logits
    v0 = _vocab_start(model, "emb" if model.cfg.tie_embeddings else "lm_head")
    pad = (v0, model.cfg.vocab - v0 - logits.shape[-1])
    return reduce_from_tp(torch.nn.functional.pad(logits, pad), model.tp)


# ===========================================================================
# family bodies
# ===========================================================================
REMATS = ("none", "full", "dots")
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def dots_policy(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of remat "dots" (JAX's
    ``dots_with_no_batch_dims_saveable``): save the output of a matmul
    with no batch dims, recompute every other op.  A kernel's plain
    version on the CPU is a black box, as the kernel is on the card: its
    ops are recomputed."""
    if op in _SAVED_DOTS and not in_plain_version():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _layer(layer: nn.Module, view: dict | None, remat: str, *args, **kwargs):
    """``layer(*args, **kwargs)``: on the cast parameters of ``view`` (by
    name within the layer; :func:`gather_view`) where given, and under
    activation checkpointing when ``remat`` is "full" (recompute all) or
    "dots" (save what :func:`dots_policy` saves)."""
    fn = layer
    if view:
        def fn(*a, **k):
            return torch.func.functional_call(layer, view, a, k)
    if remat == "full":
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    if remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False, context_fn=functools.partial(
            create_selective_checkpoint_contexts, dots_policy), **kwargs)
    return fn(*args, **kwargs)


def _sub(view: dict | None, prefix: str) -> dict | None:
    """The entries of ``view`` under ``prefix``, named within it."""
    if view is None:
        return None
    return {k[len(prefix):]: v for k, v in view.items() if k.startswith(prefix)}


def _dense(model: LM, x, qcfg, key, *, caches=None, cache_pos: int = 0, window=None,
           view=None, remat="none", seq=None):
    """The dense or MoE stack, threading the stacked KV caches ``(k, v)``
    (L, B, M, KV, hd) when given (written in place); returns ``(x, aux)``,
    aux the mean of the MoE layers' load-balance losses (0 for dense)."""
    moe = model.cfg.family == "moe"  # a MoEBlock returns (x, aux)
    auxes = []
    for i, layer in enumerate(model.layers):
        cache = (caches[0][i], caches[1][i]) if caches is not None else None
        x = _layer(layer, _sub(view, f"layers.{i}."), remat, x, qcfg, fold_in(key, i),
                   cache=cache, cache_pos=cache_pos, window=window, seq=seq)
        if moe:
            x, aux = x
            auxes.append(aux)
    if not moe:
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    return x, torch.stack(auxes).mean()


def _encoder(model: LM, batch: dict, qcfg, key, *, view=None, remat="none", seq=None):
    """The encoder: its bidirectional blocks over ``frontend_proj(src_emb)``
    (unquantized: the first layer), layer ``i`` on ``fold_in(key, 20_000 +
    i)``; ``seq``: on this rank's source frames."""
    cdt = torch_dtype(model.cfg.compute_dtype)
    src = batch["src_emb"] if seq is None else seq.take(batch["src_emb"])
    x = model.frontend_proj(src.to(cdt)).to(cdt)
    for i, layer in enumerate(model.enc_layers):
        x = _layer(layer, _sub(view, f"enc_layers.{i}."), remat, x, qcfg,
                   fold_in(key, 20_000 + i), causal=False, seq=seq)
    return x


def _xdec(model: LM, x, qcfg, key, memory=None, *, caches=None, cross=None,
          cache_pos: int = 0, view=None, remat="none", seq=None, mem_seq=None):
    """The decoder stack: cross-attention over ``memory`` (the encoder's
    output) or, serving, over the stacked cross K/V ``cross`` (L, B, Sk,
    KV, hd) x2; self-attention threads the KV caches ``caches`` when
    given."""
    for i, layer in enumerate(model.layers):
        cache = (caches[0][i], caches[1][i]) if caches is not None else None
        xc = (cross[0][i], cross[1][i]) if cross is not None else None
        x = _layer(layer, _sub(view, f"layers.{i}."), remat, x, qcfg, fold_in(key, i),
                   memory=memory, cache=cache, cross_cache=xc, cache_pos=cache_pos, seq=seq,
                   mem_seq=mem_seq)
    return x


def _ssm(model: LM, x, qcfg, key, *, states=None, view=None, remat="none", seq=None):
    """The Mamba2 stack; with ``states`` (conv (L, B, K-1, C), ssm (L, B, H,
    P, N)) returns the new ones."""
    conv, ssm = [], []
    for i, layer in enumerate(model.layers):
        st = (states[0][i], states[1][i]) if states is not None else None
        x, ns = _layer(layer, _sub(view, f"layers.{i}."), remat, x, qcfg, fold_in(key, i), st,
                       seq=seq)
        if states is not None:
            conv.append(ns[0])
            ssm.append(ns[1])
    return x, ((torch.stack(conv), torch.stack(ssm)) if states is not None else None)


def _hybrid(model: LM, x, qcfg, key, *, states=None, attn_caches=None, cache_pos: int = 0,
            kv_valid=None, positions=None, window=None, view=None, remat="none", seq=None):
    """Zamba2: Mamba2 segments of ``attn_every`` layers, the shared block
    after every full segment (instance ``si`` uses KV cache ``si``), then the
    tail of ``n_layers % attn_every`` layers.  KV caches are written in
    place; with ``states``, returns the new SSM states.  ``remat`` applies
    to the Mamba2 layers, never to the shared block."""
    cfg = model.cfg
    e, n = cfg.attn_every, cfg.n_layers
    conv, ssm = [], []
    shared = _shared_block(model)
    for i, layer in enumerate(model.layers):
        st = (states[0][i], states[1][i]) if states is not None else None
        x, ns = _layer(layer, _sub(view, f"layers.{i}."), remat, x, qcfg, fold_in(key, i), st,
                       seq=seq)
        if states is not None:
            conv.append(ns[0])
            ssm.append(ns[1])
        si, last = divmod(i + 1, e)
        if last == 0 and i < (n // e) * e:  # the end of full segment si - 1
            si -= 1
            cache = ((attn_caches[0][si], attn_caches[1][si])
                     if attn_caches is not None else None)
            x = _layer(shared, _sub(view, "shared_attn."), "none", x, qcfg,
                       fold_in(key, 10_000 + si), cache=cache, cache_pos=cache_pos,
                       kv_valid=kv_valid, positions=positions, window=window, seq=seq)
    if shared is not model.shared_attn and not torch.is_grad_enabled():
        model.shared_attn.reshard()  # no backward will
    return x, ((torch.stack(conv), torch.stack(ssm)) if states is not None else None)


def _shared_block(model: LM):
    """The hybrid's shared block as its uses call it.  In an FSDP2 group of
    its own (``shard_model`` under the 2-byte gather) its parameters are
    gathered here, once, and its forward runs without FSDP2's hooks: its
    uses then add their bf16 gradients before the one reduce-scatter of
    the root's post-backward, as the uses of its one bf16 cast do on one
    device (FSDP2's hooks would reduce after each use's backward)."""
    from torch.distributed.fsdp import FSDPModule

    block = model.shared_attn
    if not isinstance(block, FSDPModule):
        return block
    block.unshard()
    return block.forward


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
    layers see.  Under FSDP2 (``launch.train.shard_model``) a layer
    parameter is a ``DTensor`` that FSDP2 gathers in that dtype already (its
    mixed-precision policy) or that is gathered as codes after the same
    rounding (``parallel.fsdp_wire``): it is not cast twice, and a view
    left empty is None."""
    from torch.distributed.tensor import DTensor

    cfg = model.cfg
    if cfg.param_gather_dtype == "float32":
        return None
    dt = torch_dtype(cfg.param_gather_dtype)
    view = {name: (p.to(dt) if p.dtype == torch.float32 else p)
            for name, p in model.named_parameters()
            if name.startswith(("layers.", "enc_layers.", "shared_attn."))
            and not isinstance(p, DTensor)}
    return view or None


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
    with wire_scope(model):  # under packed_wire: a weight's uses share one gather proxy
        return _lm_loss(model, batch, key)


def _lm_loss(model: LM, batch: dict, key: int | None):
    cfg = model.cfg
    if cfg.remat not in REMATS:
        raise ValueError(f"remat {cfg.remat!r}: expected one of {REMATS}")
    qcfg, view = cfg.qcfg(), gather_view(model)
    seq, mem_seq = _seq_splits(model, batch)
    model.seq_split = {"dec": seq is not None, "enc": mem_seq is not None}
    kw = dict(view=view, remat=cfg.remat, seq=seq)
    memory = (_encoder(model, batch, qcfg, fold_in(key, 1), view=view, remat=cfg.remat,
                       seq=mem_seq)
              if cfg.family == "encdec" else None)
    x = embed(model, batch, seq)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in ("dense", "moe"):
        x, aux = _dense(model, x, qcfg, fold_in(key, 2), **kw)
    elif cfg.family == "ssm":
        x, _ = _ssm(model, x, qcfg, fold_in(key, 2), **kw)
    elif cfg.family == "hybrid":
        x, _ = _hybrid(model, x, qcfg, fold_in(key, 2), **kw)
    else:
        x = _xdec(model, x, qcfg, fold_in(key, 2), memory, mem_seq=mem_seq, **kw)
    logits = logits_fn(model, model.final_norm(x), seq)

    tokens = batch["tokens"]
    own = seq is not None and not _vocab_split(model)  # the head on the rank's tokens
    if own:  # position p's target is token p + 1; the sequence's last has none
        pos = torch.arange(seq.start, seq.start + seq.n, device=x.device)
        targets = seq.take(torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1))
        lg = logits.float()
        valid = (pos < tokens.shape[1] - 1)[None, :].expand(targets.shape)
    else:
        targets = tokens[:, 1:]
        lg = logits[:, :-1].float()
        pos = torch.arange(targets.shape[1], device=x.device)
        valid = torch.ones(targets.shape, dtype=torch.bool, device=x.device)
    if not _vocab_split(model):
        lse = torch.logsumexp(lg, dim=-1)
        ll = torch.gather(lg, -1, targets[..., None].long())[..., 0]
    else:
        head = "emb" if cfg.tie_embeddings else "lm_head"
        lse, ll = vocab_parallel_ce(lg, targets, _vocab_start(model, head), model.tp)
    mask = valid.float()
    if cfg.frontend != "none" and cfg.frontend_len and cfg.family != "encdec":
        # no training on the frontend's positions (the encoder-decoder's
        # frontend feeds its encoder, not these positions)
        mask = mask * (pos[None, :] >= cfg.frontend_len)
    total, count = torch.sum((lse - ll) * mask), torch.sum(mask)
    if own:  # the token sums of every rank
        total, count = reduce_from_tp(total, model.tp), reduce_from_tp(count, model.tp)
    ce = total / torch.clamp(count, min=1.0)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def _seq_splits(model: LM, batch: dict):
    """``(seq, mem_seq)``: the splits of this call's sequence and (the
    encoder-decoder's) source frames over the model group under sequence
    parallelism (``parallel.tensor.split_seq``), None where they stay
    whole or without it."""
    if not model.seq_shard:
        return None, None
    unit = seq_unit(model.cfg, model.tp.size)
    seq = split_seq(model.tp, batch["tokens"].shape[1], unit)
    mem = None
    if model.cfg.family == "encdec" and "src_emb" in batch:
        mem = split_seq(model.tp, batch["src_emb"].shape[1], unit)
    return seq, mem


# ===========================================================================
# caches / serving
# ===========================================================================
def cache_spec(cfg: ModelConfig, batch: int, max_len: int, src_len: int = SRC_LEN,
               tp=None) -> dict[str, tuple]:
    """``{name: (shape, dtype)}`` of the decode cache's tensors; the
    encoder-decoder's also holds the cross-attention K/V ``xk``/``xv`` of
    ``src_len`` encoder positions.  ``tp`` (a ``parallel.tensor.
    TensorParallel``: its ``rank`` of ``size``): that rank's part under
    tensor parallelism, the kv heads its query heads read
    (``rank_heads``: all of them where the attention stays replicated),
    and of a Mamba2 layer its heads' SSM states and the
    conv channels of their ``x`` (on ``TAIL_RANK`` also ``B``, ``C``)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown LM family {cfg.family!r}; expected one of {FAMILIES}")
    dt = torch_dtype(cfg.compute_dtype)
    hd, kv, n = cfg.hd, cfg.n_kv_heads, cfg.n_layers
    heads, bc = cfg.ssm_heads, 2 * cfg.ssm_groups * cfg.ssm_state
    if tp is not None and tp.size > 1:
        if cfg.n_heads:
            kv = rank_heads(cfg, tp.size, tp.rank)[1]
        if cfg.family in ("ssm", "hybrid"):
            h0, h1 = mamba_heads(cfg, tp.size)[tp.rank]
            heads, bc = h1 - h0, bc if tp.rank == TAIL_RANK else 0
    if cfg.family in ("dense", "moe", "encdec"):
        spec = {"k": ((n, batch, max_len, kv, hd), dt), "v": ((n, batch, max_len, kv, hd), dt)}
        if cfg.family == "encdec":
            spec.update(xk=((n, batch, src_len, kv, hd), dt), xv=((n, batch, src_len, kv, hd), dt))
        return spec
    conv_dim = heads * cfg.ssm_headdim + bc
    spec = {"conv": ((n, batch, cfg.ssm_conv - 1, conv_dim), dt),
            "ssm": ((n, batch, heads, cfg.ssm_headdim, cfg.ssm_state), torch.float32)}
    if cfg.family == "hybrid":
        alen = min(max_len, cfg.window) if cfg.window else max_len
        shape = (n // cfg.attn_every, batch, alen, kv, hd)
        spec.update(ak=(shape, dt), av=(shape, dt))
    return spec


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: str | torch.device = "cuda", src_len: int = SRC_LEN, tp=None) -> dict:
    """A zero cache at position 0 on ``device`` (``tp``: a rank's part,
    :func:`cache_spec`)."""
    cache: dict = {name: torch.zeros(shape, dtype=dt, device=device)
                   for name, (shape, dt) in cache_spec(cfg, batch, max_len, src_len,
                                                       tp).items()}
    cache["pos"] = 0
    return cache


def serve_qcfg(cfg: ModelConfig) -> QuantConfig | None:
    """The quantized linears' config at inference: ``cfg.qcfg()`` with
    nearest rounding (no stochastic rounding)."""
    qcfg = cfg.qcfg()
    return None if qcfg is None else dataclasses.replace(qcfg, stochastic=False)


def prefill(model: LM, batch: dict, max_len: int) -> tuple[torch.Tensor, dict]:
    """Run the whole prompt ``batch["tokens"]`` (B, S), filling a new cache
    of ``max_len`` positions; returns ``(logits of the last position fp32
    (B, vocab), cache)``.  The encoder-decoder encodes ``batch["src_emb"]``
    and puts each decoder layer's cross K/V of it, unquantized, into the
    cache.  Tensor-parallel: this rank's cache, the whole logits (module
    docstring).  Runs ``model.prefill``."""
    return model.prefill(batch, max_len)


@torch.no_grad()
def _prefill(model: LM, batch: dict, max_len: int) -> tuple[torch.Tensor, dict]:
    cfg, qcfg = model.cfg, serve_qcfg(model.cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    src_len = batch["src_emb"].shape[1] if "src_emb" in batch else SRC_LEN
    cache = init_cache(cfg, b, max_len, tokens.device, src_len, model.tp)
    seq, mem_seq = _seq_splits(model, batch)
    x = embed(model, batch, seq)
    if cfg.family in ("dense", "moe"):
        x, _ = _dense(model, x, qcfg, None, caches=(cache["k"], cache["v"]), seq=seq)
    elif cfg.family == "ssm":
        x, (cache["conv"], cache["ssm"]) = _ssm(model, x, qcfg, None,
                                                 states=(cache["conv"], cache["ssm"]), seq=seq)
    elif cfg.family == "hybrid":
        x, (cache["conv"], cache["ssm"]) = _hybrid(
            model, x, qcfg, None, states=(cache["conv"], cache["ssm"]),
            attn_caches=(cache["ak"], cache["av"]), seq=seq)
    else:
        memory = _encoder(model, batch, qcfg, None, seq=mem_seq)
        if mem_seq is not None:
            memory = gather_seq(memory, mem_seq)
        for i, layer in enumerate(model.layers):  # the cross K/V, once, unquantized
            cache["xk"][i], cache["xv"][i] = layer.cross_kv(memory)
        x = _xdec(model, x, qcfg, None, caches=(cache["k"], cache["v"]),
                  cross=(cache["xk"], cache["xv"]), seq=seq)
    cache["pos"] = s
    if seq is not None:
        x = gather_seq(x, seq)
    return whole_logits(model, logits_fn(model, model.final_norm(x[:, -1:])))[:, 0], cache


def decode_step(model: LM, cache: dict, tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One serving step: ``tokens`` (B, 1) -> ``(logits fp32 (B, vocab),
    cache)``, the cache one position further.  Tensor-parallel: this
    rank's cache, the whole logits (module docstring).  Runs
    ``model.decode_step``."""
    return model.decode_step(cache, tokens)


@torch.no_grad()
def _decode_step(model: LM, cache: dict, tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
    cfg, qcfg = model.cfg, serve_qcfg(model.cfg)
    x = embed(model, {"tokens": tokens})
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
    return whole_logits(model, logits_fn(model, model.final_norm(x)))[:, 0], new_cache
