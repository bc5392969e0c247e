"""Attention layers (counterpart of
``deeplearning4j_tpu/nn/layers/attention.py``).

:class:`SelfAttentionLayer` and :class:`TransformerEncoderLayer` are
layers of the port's layer DSL: ``apply_seq`` is the training forward
``MultiLayerNetwork`` drives (autograd gives the backward), and the
serving methods (prefill, decode, paged decode, chunked prefill and
the speculative verify span) are what ``CausalTransformerLM`` calls.
Each method takes an explicit params dict with weights shaped
``[in, out]`` and applied as ``x @ W``, so JAX weights carry over as a
plain copy.

Attention over a whole sequence goes through the flash kernels on the
card (forward B3, backward B6/B7 through
:func:`~..kernels.flash_attention.flash_attention_autograd`), so
gradients reach Wq, Wk and Wv. Under the bf16 policy the projections
and the MLP are bf16 ``torch.matmul`` (f32 accumulation; JAX left them
to XLA) and q, k, v go to the kernels' bf16 legs; on the CPU the plain
path computes in f32 from the bf16 values and returns bf16, as JAX's
plain path does. The decode and paged-prefill paths
write K/V into the cache or pool tensors in place; the JAX code
returned updated caches that the executables donated.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ... import random as R
from ...kernels.decode_attention import decode_attention
from ...kernels.flash_attention import flash_attention_autograd
from ...kernels.kv_quant import QuantArray, is_quantized, kv_set, mm
from ...kernels.paged_attention import paged_attention
from ...parallel.longseq import dot_product_attention
from ...weightinit import init_weights, subkeys
from ..functional import layer_norm, matmul
from . import Layer, register


def _cache_row(cache, i):
    """Leading-axis row of a cache; an int8 QuantArray's scale row
    comes with its values (the scales drop only the trailing axis).
    ``i`` is a host int (a view) or a 1-element device tensor (a
    gathered copy, no host sync)."""
    if isinstance(i, torch.Tensor):
        idx = i.reshape(1).long()
        if is_quantized(cache):
            return QuantArray(cache.q.index_select(0, idx)[0],
                              cache.scale.index_select(0, idx)[0])
        return cache.index_select(0, idx)[0]
    if is_quantized(cache):
        return QuantArray(cache.q[i], cache.scale[i])
    return cache[i]


def _gather_span(pool, block_table, H, Dh):
    """Gather a sequence's block-table span out of a paged pool into
    one [H, T, Dh] panel (T = n_blocks * Bs). An int8 pool gathers its
    values and its [H, T] scales through the same table."""
    idx = block_table.long()
    if is_quantized(pool):
        return QuantArray(pool.q[idx].transpose(0, 1).reshape(H, -1, Dh),
                          pool.scale[idx].transpose(0, 1).reshape(H, -1))
    return pool[idx].transpose(0, 1).reshape(H, -1, Dh)


def _span_attend(q, kk, vv, gpos, p0c, out_dtype):
    """Causal span attention over one gathered K/V panel, the math of
    :meth:`SelfAttentionLayer.apply_prefill_paged` and
    :meth:`SelfAttentionLayer.apply_verify` (counterpart of the JAX
    ``_span_attend``, plain PyTorch as it was plain jnp there).

    q: [C, H, Dh] span queries; kk/vv: [H, T, Dh] f32 or bf16 panels,
    or int8 QuantArrays with [H, T] scales; gpos: [C] global positions
    (row c sees keys j <= gpos[c]); p0c: the first position NOT written
    by this sequence (p0 + C): V beyond it is a previous occupant's
    stale leavings and may be non-finite, so it is zeroed
    (0 * NaN = NaN). bf16 and int8 panels run bf16-operand products
    with f32 accumulation; int8 scales apply after the QK product for K
    and fold into p for V, where-guarded, as in the decode kernels."""
    for x in (kk, vv):
        if not is_quantized(x) and x.dtype not in (torch.float32,
                                                   torch.bfloat16):
            raise TypeError(f"a {x.dtype} panel: int8 panels are "
                            f"QuantArrays that carry their scales")
    H, T, Dh = kk.shape
    scale = 1.0 / math.sqrt(Dh)
    ar = torch.arange(T, device=q.device)
    valid = ar[None, None, :] <= gpos[None, :, None]
    written = (ar < p0c)[None, :, None]
    if is_quantized(kk) or kk.dtype == torch.bfloat16:
        kb = kk.q if is_quantized(kk) else kk
        vb = vv.q if is_quantized(vv) else vv
        # bf16 and int8 products are exact in f32: an f32 einsum over
        # bf16-rounded operands is the bf16 dot with f32 accumulation
        s = torch.einsum("chd,htd->hct", q.to(torch.bfloat16).float(),
                         kb.to(torch.bfloat16).float()) * scale
        if is_quantized(kk):
            s = s * kk.scale[:, None, :]
        s = torch.where(valid, s, -1e30)
        p = torch.softmax(s, dim=-1)
        if is_quantized(vv):
            p = torch.where(valid, p * vv.scale[:, None, :], 0.0)
        else:
            p = torch.where(valid, p, 0.0)
        vb = torch.where(written, vb.to(torch.bfloat16).float(), 0.0)
        att = torch.einsum("hct,htd->chd", p.to(torch.bfloat16).float(), vb)
        return att.to(out_dtype)
    s = torch.einsum("chd,htd->hct", q.float(), kk.float()) * scale
    s = torch.where(valid, s, -1e30)
    p = torch.where(valid, torch.softmax(s, dim=-1), 0.0)
    vv = torch.where(written, vv.float(), 0.0)
    return torch.einsum("hct,htd->chd", p, vv).to(out_dtype)


@register
class SelfAttentionLayer(Layer):
    """Multi-head self-attention over [B, T, C] input.

    ``implementation``: ``"auto"`` takes the flash kernels on the card
    and plain attention on the CPU; ``"flash"`` takes the flash path
    (the kernels, or their plain versions for CPU tensors) everywhere;
    ``"plain"`` takes plain attention everywhere."""

    kind = "selfattention"
    is_rnn = True

    def __init__(self, n_heads: int = 4, n_out: Optional[int] = None,
                 causal: bool = False, implementation: str = "auto", **kw):
        kw.setdefault("activation", "identity")
        super().__init__(**kw)
        self.n_heads = int(n_heads)
        self.n_out = n_out
        self.causal = bool(causal)
        if implementation == "blockwise":
            raise NotImplementedError(
                "blockwise attention is not ported yet (ROADMAP.md queue "
                "A, item 14b)")
        if implementation not in ("auto", "plain", "flash"):
            raise ValueError(f"unknown implementation {implementation!r}")
        self.implementation = implementation
        self.n_in: Optional[int] = None

    def build(self, input_shape, defaults=None):
        super().build(input_shape, defaults)
        self.n_in = int(input_shape[-1])
        if self.n_out is None:
            self.n_out = self.n_in
        if self.n_out % self.n_heads:
            raise ValueError(f"n_heads={self.n_heads} must divide "
                             f"n_out={self.n_out}")

    def param_shapes(self):
        d, o = self.n_in, self.n_out
        return {"Wq": (d, o), "Wk": (d, o), "Wv": (d, o), "Wo": (o, o),
                "b": (o,)}

    def init_params(self, key, dtype=torch.float32):
        d, o = self.n_in, self.n_out
        p = {n: init_weights(k, (din, o), din, o, self.weight_init, dtype)
             for (n, din), k in zip((("Wq", d), ("Wk", d), ("Wv", d),
                                     ("Wo", o)), subkeys(key, 4))}
        p["b"] = torch.zeros((o,), dtype=dtype)
        return p

    def _attend(self, q, k, v, mask):
        # on the card "auto" is flash at every length: the JAX threshold
        # (flags.flash_min_seq = 1024) was tuned on a TPU, and the
        # card's own crossover is not measured yet
        flash = self.implementation == "flash" or (
            self.implementation == "auto" and q.is_cuda)
        if flash:
            return flash_attention_autograd(q, k, v, causal=self.causal,
                                            key_mask=mask)
        return dot_product_attention(
            q, k, v, mask=None if mask is None else mask[:, None, None, :] > 0,
            causal=self.causal)

    def _project(self, params, x, shape):
        return (matmul(x, params["Wq"]).reshape(shape),
                matmul(x, params["Wk"]).reshape(shape),
                matmul(x, params["Wv"]).reshape(shape))

    def apply_seq(self, params, x, state, train, rng, carry, mask):
        """Forward over x [B, T, C]; ``mask`` is an optional [B, T]
        validity that also zeroes padded output rows. Returns (out,
        state, carry)."""
        B, T, _ = x.shape
        H = self.n_heads
        x = self._maybe_dropout(x, train, rng)
        q, k, v = self._project(params, x, (B, T, H, self.n_out // H))
        att = self._attend(q, k, v, mask)
        out = matmul(att.reshape(B, T, self.n_out), params["Wo"]) + params["b"]
        if mask is not None:
            out = out * mask[..., None]
        return self.activation(out), state, carry

    def output_shape(self, input_shape):
        return (input_shape[0], self.n_out)

    def _extra_json(self):
        return {"n_heads": self.n_heads, "n_out": self.n_out,
                "causal": self.causal,
                "implementation": self.implementation}

    def cache_shape(self, max_seq_len: int):
        """Per-sequence K (== V) cache shape [n_heads, max_seq_len,
        head_dim]: T contiguous per head."""
        return (self.n_heads, int(max_seq_len), self.n_out // self.n_heads)

    def apply_prefill(self, params, x, key_mask=None):
        """Prompt pass that also returns per-position K/V in cache
        layout. Requires ``causal=True``. x: [B, T, C]; key_mask:
        optional [B, T]. Returns (out [B, T, n_out], k [B, H, T, Dh],
        v [B, H, T, Dh])."""
        if not self.causal:
            raise ValueError("cached decode needs causal=True attention")
        B, T, _ = x.shape
        H = self.n_heads
        q, k, v = self._project(params, x, (B, T, H, self.n_out // H))
        att = self._attend(q, k, v, key_mask)
        out = att.reshape(B, T, self.n_out) @ params["Wo"] + params["b"]
        if key_mask is not None:
            out = out * key_mask[..., None]
        return out, k.transpose(1, 2), v.transpose(1, 2)

    def apply_decode(self, params, x, k_cache, v_cache, pos):
        """One cached decode step: project the current token, write its
        K/V at ``pos`` into the caches IN PLACE, attend over positions
        0..pos. x: [B, C]; k_cache/v_cache: [B, H, T_max, Dh]; pos: [B]
        integer write positions. Returns (out [B, n_out], k_cache,
        v_cache), the caches being the same tensors."""
        B = x.shape[0]
        H = self.n_heads
        q, k_t, v_t = self._project(params, x, (B, H, self.n_out // H))
        rows = torch.arange(B, device=x.device)[:, None]
        heads = torch.arange(H, device=x.device)[None, :]
        idx = (rows, heads, pos[:, None])
        kv_set(k_cache, idx, k_t)
        kv_set(v_cache, idx, v_t)
        att = decode_attention(q, k_cache, v_cache,
                               (pos + 1).to(torch.int32))
        out = att.reshape(B, self.n_out) @ params["Wo"] + params["b"]
        return out, k_cache, v_cache

    def apply_decode_paged(self, params, x, k_pool, v_pool, block_tables,
                           pos):
        """One cached decode step against the paged pool: write the
        current token's K/V at ``pool[table[pos // Bs], :, pos % Bs]``
        IN PLACE, attend over the prefix through the block table.
        x: [B, C]; k_pool/v_pool: [N, H, Bs, Dh]; block_tables:
        [B, n_blocks] int32 (NULL_BLOCK-padded); pos: [B]. Inactive
        rows carry NULL_BLOCK tables, so their writes land in the null
        block (several rows may write the same place there; which one
        wins is undefined and nothing reads it). Returns (out
        [B, n_out], k_pool, v_pool), the pools being the same
        tensors."""
        B = x.shape[0]
        H = self.n_heads
        Bs = k_pool.shape[2]
        q, k_t, v_t = self._project(params, x, (B, H, self.n_out // H))
        pos = pos.long()
        blk = block_tables.long().gather(1, (pos // Bs)[:, None])
        heads = torch.arange(H, device=x.device)[None, :]
        idx = (blk, heads, (pos % Bs)[:, None])
        kv_set(k_pool, idx, k_t)
        kv_set(v_pool, idx, v_t)
        att = paged_attention(q, k_pool, v_pool,
                              block_tables.to(torch.int32),
                              (pos + 1).to(torch.int32))
        out = att.reshape(B, self.n_out) @ params["Wo"] + params["b"]
        return out, k_pool, v_pool

    def apply_prefill_paged(self, params, x, k_pool, v_pool, block_table,
                            p0, chunk_len):
        """One prefill CHUNK against the paged pool: project the chunk,
        write its K/V into the owning blocks IN PLACE, and attend each
        chunk query causally over the gathered prefix (earlier chunks +
        this one). x: [1, C, Cin] (C is the chunk bucket); block_table:
        [n_blocks] covering at least ``p0 + C`` positions (an index past
        it raises: an undersized table is the one fatal case, because
        the padded rows would alias another sequence's blocks); p0: the
        chunk's first global position; chunk_len: its valid rows. p0 and
        chunk_len are host ints or 0-d device tensors (a CUDA graph's
        runtime arguments); nothing here reads them on the host.
        Padded rows write junk past the live length or into the null
        block, where every reader's mask keeps it dark. Returns (out
        [1, C, n_out], k_pool, v_pool)."""
        if not self.causal:
            raise ValueError("cached decode needs causal=True attention")
        C = x.shape[1]
        H = self.n_heads
        Dh = self.n_out // H
        Bs = k_pool.shape[2]
        q, k_t, v_t = self._project(params, x[0], (C, H, Dh))
        gpos = torch.arange(C, device=x.device) + p0
        blk = block_table.long()[gpos // Bs]
        heads = torch.arange(H, device=x.device)[None, :]
        idx = (blk[:, None], heads, (gpos % Bs)[:, None])
        kv_set(k_pool, idx, k_t)
        kv_set(v_pool, idx, v_t)
        kk = _gather_span(k_pool, block_table, H, Dh)
        vv = _gather_span(v_pool, block_table, H, Dh)
        att = _span_attend(q, kk, vv, gpos, p0 + C, x.dtype)
        out = att.reshape(C, self.n_out) @ params["Wo"] + params["b"]
        return out[None], k_pool, v_pool

    def apply_verify(self, params, x, k_cache, v_cache, slot, p0,
                     chunk_len):
        """A speculative verify span against the dense slot cache, the
        slot-backend sibling of :meth:`apply_prefill_paged`: write the
        span's K/V at positions ``p0 + i`` of ``slot``'s panel IN PLACE,
        then attend each row causally over the whole panel.

        x: [1, C, Cin] (C is the verify bucket); k_cache/v_cache:
        [S, H, T_max, Dh]; slot: a host int or a 1-element device
        tensor; p0 (< T_max, a lane's position): a host int or a 0-d
        device tensor; chunk_len: valid rows (padded rows write junk
        past the live length, masked by every reader until an accepted
        write overwrites it). Rows at positions >= T_max are not
        written, as JAX's scatter drops them, and with no host value:
        every row writes at ``min(p0 + i, T_max - 1)`` the K/V of row
        ``min(i, T_max - 1 - p0)``, so the rows past the panel repeat
        the last in-panel row's write, value for value (no index past
        the panel, no duplicate writes of different values). Returns
        (out [1, C, n_out], k_cache, v_cache)."""
        if not self.causal:
            raise ValueError("cached decode needs causal=True attention")
        C = x.shape[1]
        H = self.n_heads
        Dh = self.n_out // H
        q, k_t, v_t = self._project(params, x[0], (C, H, Dh))
        gpos = torch.arange(C, device=x.device) + p0
        wpos = gpos.clamp(max=k_cache.shape[2] - 1)
        src = wpos - p0
        heads = torch.arange(H, device=x.device)[None, :]
        row = (slot.reshape(1, 1).long() if isinstance(slot, torch.Tensor)
               else int(slot))
        idx = (row, heads, wpos[:, None])
        kv_set(k_cache, idx, k_t[src])
        kv_set(v_cache, idx, v_t[src])
        att = _span_attend(q, _cache_row(k_cache, slot),
                           _cache_row(v_cache, slot), gpos, p0 + C, x.dtype)
        out = att.reshape(C, self.n_out) @ params["Wo"] + params["b"]
        return out[None], k_cache, v_cache


@register
class TransformerEncoderLayer(Layer):
    """Pre-LN transformer block: x + MHA(LN(x)); x + MLP(LN(x)), the
    MLP's GELU in tanh form (as ``jax.nn.gelu``)."""

    kind = "transformerencoder"
    is_rnn = True

    def __init__(self, n_heads: int = 4, d_ff: Optional[int] = None,
                 causal: bool = False, implementation: str = "auto", **kw):
        kw.setdefault("activation", "identity")
        super().__init__(**kw)
        self.n_heads = int(n_heads)
        self.d_ff = d_ff
        self.causal = causal
        self.implementation = implementation
        self.attn: Optional[SelfAttentionLayer] = None
        self.d_model: Optional[int] = None

    def build(self, input_shape, defaults=None):
        super().build(input_shape, defaults)
        self.d_model = int(input_shape[-1])
        if self.d_ff is None:
            self.d_ff = 4 * self.d_model
        # the block's dropout and init settings reach its attention
        self.attn = SelfAttentionLayer(
            n_heads=self.n_heads, causal=self.causal,
            implementation=self.implementation, dropout=self.dropout,
            weight_init=self.weight_init)
        self.attn.build(input_shape, defaults)

    def param_shapes(self):
        d, f = self.d_model, self.d_ff
        sh = {f"attn_{k}": v for k, v in self.attn.param_shapes().items()}
        sh.update({"ln1_g": (d,), "ln1_b": (d,), "ln2_g": (d,),
                   "ln2_b": (d,), "W1": (d, f), "b1": (f,),
                   "W2": (f, d), "b2": (d,)})
        return sh

    def init_params(self, key, dtype=torch.float32):
        d, f = self.d_model, self.d_ff
        k1, k2, k3 = subkeys(key, 3)
        p = {f"attn_{k}": v
             for k, v in self.attn.init_params(k1, dtype).items()}
        p.update({
            "ln1_g": torch.ones((d,), dtype=dtype),
            "ln1_b": torch.zeros((d,), dtype=dtype),
            "ln2_g": torch.ones((d,), dtype=dtype),
            "ln2_b": torch.zeros((d,), dtype=dtype),
            "W1": init_weights(k2, (d, f), d, f, self.weight_init,
                               dtype),
            "b1": torch.zeros((f,), dtype=dtype),
            "W2": init_weights(k3, (f, d), f, d, self.weight_init,
                               dtype),
            "b2": torch.zeros((d,), dtype=dtype)})
        return p

    def apply_seq(self, params, x, state, train, rng, carry, mask):
        """Training (and plain inference) forward of the block over
        x [B, T, C]. Returns (out, state, carry)."""
        h = layer_norm(x, params["ln1_g"], params["ln1_b"])
        att, _, _ = self.attn.apply_seq(self._attn_params(params), h, None,
                                        train, rng, (), mask)
        x = x + att
        h = layer_norm(x, params["ln2_g"], params["ln2_b"])
        h = F.gelu(matmul(h, params["W1"]) + params["b1"],
                   approximate="tanh")
        # the MLP's dropout key is folded from the attention's, as in
        # JAX, so the two masks are independent
        mlp_rng = R.fold_in(rng, 1) \
            if rng is not None and self.dropout else None
        h = self._maybe_dropout(h, train, mlp_rng)
        x = x + (matmul(h, params["W2"]) + params["b2"])
        if mask is not None:
            x = x * mask[..., None]
        return x, state, carry

    def _extra_json(self):
        return {"n_heads": self.n_heads, "d_ff": self.d_ff,
                "causal": self.causal,
                "implementation": self.implementation}

    def cache_shape(self, max_seq_len: int):
        return self.attn.cache_shape(max_seq_len)

    @staticmethod
    def _attn_params(params):
        return {k[len("attn_"):]: v for k, v in params.items()
                if k.startswith("attn_")}

    def _mlp(self, params, x):
        # jax.nn.gelu defaults to the tanh approximation; torch's
        # default is the exact erf form. ``mm`` takes int8 weight-only
        # QuantWeights (quantize_mlp_weights) as well as plain weights
        h = layer_norm(x, params["ln2_g"], params["ln2_b"])
        h = F.gelu(mm(h, params["W1"]) + params["b1"], approximate="tanh")
        return x + (mm(h, params["W2"]) + params["b2"])

    def apply_prefill(self, params, x, key_mask=None):
        """Block prefill, also returning this block's K/V for the
        decode cache."""
        h = layer_norm(x, params["ln1_g"], params["ln1_b"])
        att, k, v = self.attn.apply_prefill(self._attn_params(params), h,
                                            key_mask)
        x = self._mlp(params, x + att)
        if key_mask is not None:
            x = x * key_mask[..., None]
        return x, k, v

    def apply_decode(self, params, x, k_cache, v_cache, pos):
        """One cached decode step through the block (x: [B, C]); the
        caches are written in place."""
        h = layer_norm(x, params["ln1_g"], params["ln1_b"])
        att, k_cache, v_cache = self.attn.apply_decode(
            self._attn_params(params), h, k_cache, v_cache, pos)
        return self._mlp(params, x + att), k_cache, v_cache

    def apply_decode_paged(self, params, x, k_pool, v_pool, block_tables,
                           pos):
        """One cached decode step through the block against the paged
        pool (see :meth:`SelfAttentionLayer.apply_decode_paged`)."""
        h = layer_norm(x, params["ln1_g"], params["ln1_b"])
        att, k_pool, v_pool = self.attn.apply_decode_paged(
            self._attn_params(params), h, k_pool, v_pool, block_tables,
            pos)
        return self._mlp(params, x + att), k_pool, v_pool

    def apply_prefill_paged(self, params, x, k_pool, v_pool, block_table,
                            p0, chunk_len):
        """One prefill chunk through the block against the paged pool
        (see :meth:`SelfAttentionLayer.apply_prefill_paged`)."""
        h = layer_norm(x, params["ln1_g"], params["ln1_b"])
        att, k_pool, v_pool = self.attn.apply_prefill_paged(
            self._attn_params(params), h, k_pool, v_pool, block_table, p0,
            chunk_len)
        return self._mlp(params, x + att), k_pool, v_pool

    def apply_verify(self, params, x, k_cache, v_cache, slot, p0,
                     chunk_len):
        """One verify span through the block against the dense slot
        cache (see :meth:`SelfAttentionLayer.apply_verify`)."""
        h = layer_norm(x, params["ln1_g"], params["ln1_b"])
        att, k_cache, v_cache = self.attn.apply_verify(
            self._attn_params(params), h, k_cache, v_cache, slot, p0,
            chunk_len)
        return self._mlp(params, x + att), k_cache, v_cache
