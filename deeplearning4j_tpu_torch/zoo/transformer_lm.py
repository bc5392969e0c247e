"""Decoder-only causal transformer LM, the generation-serving workload
(counterpart of ``deeplearning4j_tpu/zoo/transformer_lm.py``).

Learned token and position embeddings, ``n_layers`` pre-LN blocks of
causal self-attention, a final LayerNorm and a linear head. The
forwards are functions of an explicit params dict laid out exactly as
the JAX pytree (``tok``, ``pos``, ``lnf_g``, ``lnf_b``, ``head``,
``blocks[i]`` with ``attn_Wq`` ... ``b2``), weights ``[in, out]``, so
:meth:`CausalTransformerLM.load_params` takes JAX weights as a copy.

The model lives on the GPU unless ``device="cpu"`` is asked for.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from .. import random as R
from ..device import resolve_device
from ..nn.functional import layer_norm
from ..nn.layers.attention import TransformerEncoderLayer
from ..weightinit import subkeys


class CausalTransformerLM(nn.Module):
    """Token-in/logits-out causal LM with a cached decode path.
    ``max_seq_len`` bounds the position table and the decode cache."""

    def __init__(self, vocab_size: int, d_model: int = 128,
                 n_layers: int = 2, n_heads: int = 4,
                 d_ff: Optional[int] = None, max_seq_len: int = 256,
                 eos_id: Optional[int] = None, seed: int = 0,
                 device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.vocab_size = int(vocab_size)
        self.d_model = int(d_model)
        self.n_layers = int(n_layers)
        self.n_heads = int(n_heads)
        self.max_seq_len = int(max_seq_len)
        self.eos_id = eos_id
        self.seed = int(seed)
        self.blocks: List[TransformerEncoderLayer] = []
        for _ in range(self.n_layers):
            blk = TransformerEncoderLayer(n_heads=n_heads, d_ff=d_ff,
                                          causal=True)
            blk.build((self.max_seq_len, self.d_model))
            self.blocks.append(blk)
        self._params = None

    # -- lifecycle -----------------------------------------------------
    def init(self) -> "CausalTransformerLM":
        """Random weights from ``seed``, drawn on the model's device from
        JAX's keys (the JAX model's weights from the same seed)."""
        k_tok, k_pos, k_head, k_blocks = subkeys(R.PRNGKey(self.seed), 4)
        V, D = self.vocab_size, self.d_model
        with torch.device(self.device):
            params = {
                "tok": R.normal(k_tok, (V, D)) * 0.02,
                "pos": R.normal(k_pos, (self.max_seq_len, D)) * 0.02,
                "lnf_g": torch.ones((D,)), "lnf_b": torch.zeros((D,)),
                "head": R.normal(k_head, (D, V)) * 0.02,
                "blocks": [blk.init_params(k) for blk, k in zip(
                    self.blocks, subkeys(k_blocks, self.n_layers))],
            }
        self._params = params
        return self

    def load_params(self, tree) -> "CausalTransformerLM":
        """Take weights from the JAX model's params pytree as numpy
        arrays (``jax.tree.map(np.asarray, lm._params)``)."""
        from ..convert import params_from_jax
        params = params_from_jax(tree, self.device)
        want = {"tok": (self.vocab_size, self.d_model),
                "pos": (self.max_seq_len, self.d_model),
                "lnf_g": (self.d_model,), "lnf_b": (self.d_model,),
                "head": (self.d_model, self.vocab_size)}
        for name, shape in want.items():
            if tuple(params[name].shape) != shape:
                raise ValueError(f"{name}: shape {tuple(params[name].shape)}"
                                 f" != {shape}")
        if len(params["blocks"]) != self.n_layers:
            raise ValueError(f"{len(params['blocks'])} blocks, model has "
                             f"{self.n_layers}")
        for i, (blk, bp) in enumerate(zip(self.blocks, params["blocks"])):
            for name, shape in blk.param_shapes().items():
                if tuple(bp[name].shape) != tuple(shape):
                    raise ValueError(f"blocks[{i}].{name}: shape "
                                     f"{tuple(bp[name].shape)} != {shape}")
        self._params = params
        return self

    def cache_shapes(self, max_seq_len: Optional[int] = None
                     ) -> List[Tuple[int, int, int]]:
        """Per-layer per-sequence K (== V) cache shape [n_heads,
        max_seq_len, head_dim]; ``max_seq_len`` may be below the
        position table's. ``cache_shapes(block_size)`` gives the paged
        pool's per-block shapes."""
        n = self.max_seq_len if max_seq_len is None else int(max_seq_len)
        if n > self.max_seq_len:
            raise ValueError(f"cache length {n} exceeds the position "
                             f"table ({self.max_seq_len})")
        return [blk.cache_shape(n) for blk in self.blocks]

    # -- forwards ------------------------------------------------------
    def forward_prefill(self, params, tokens, key_mask=None):
        """Full-prompt causal pass. tokens: [B, T] integer; key_mask:
        optional [B, T] f32 validity. Returns (logits [B, T, V], ks, vs)
        with per-layer [B, H, T, Dh] K/V slabs in cache layout."""
        B, T = tokens.shape
        pos = torch.arange(T, device=tokens.device)
        x = params["tok"][tokens] + params["pos"][pos][None]
        if key_mask is not None:
            x = x * key_mask[..., None]
        ks, vs = [], []
        for blk, bp in zip(self.blocks, params["blocks"]):
            x, k, v = blk.apply_prefill(bp, x, key_mask)
            ks.append(k)
            vs.append(v)
        x = layer_norm(x, params["lnf_g"], params["lnf_b"])
        return x @ params["head"], ks, vs

    def forward_decode(self, params, tokens, pos, k_caches, v_caches):
        """One cached decode step for a batch of slots. tokens: [S]
        current token per slot; pos: [S] its position; k_caches/
        v_caches: per-layer [S, H, T_max, Dh], written IN PLACE at
        ``pos``. Returns (logits [S, V], k_caches, v_caches)."""
        x = params["tok"][tokens] + params["pos"][pos]
        for blk, bp, kc, vc in zip(self.blocks, params["blocks"],
                                   k_caches, v_caches):
            x, _, _ = blk.apply_decode(bp, x, kc, vc, pos)
        x = layer_norm(x, params["lnf_g"], params["lnf_b"])
        return x @ params["head"], k_caches, v_caches

    def forward_decode_paged(self, params, tokens, pos, k_pools, v_pools,
                             block_tables):
        """One cached decode step against the paged pools: the contract
        of :meth:`forward_decode` with per-layer pools [num_blocks, H,
        block_size, Dh], written IN PLACE, addressed through
        ``block_tables`` [S, n_blocks] int32 (NULL_BLOCK-padded;
        inactive rows are all-NULL so their writes land in the null
        block)."""
        x = params["tok"][tokens] + params["pos"][pos]
        for blk, bp, kc, vc in zip(self.blocks, params["blocks"],
                                   k_pools, v_pools):
            x, _, _ = blk.apply_decode_paged(bp, x, kc, vc, block_tables,
                                             pos)
        x = layer_norm(x, params["lnf_g"], params["lnf_b"])
        return x @ params["head"], k_pools, v_pools

    def forward_prefill_chunk(self, params, tokens, p0, chunk_len,
                              k_pools, v_pools, block_table):
        """One prefill CHUNK against the paged pools: embed the chunk at
        its global positions, run every block's ``apply_prefill_paged``
        (K/V written into the owning blocks in place, causal attention
        over the gathered prefix) and return the chunk's logits. The
        caller feeds a prompt's chunks in order and samples the last
        one's row ``chunk_len - 1``.

        tokens: [1, C] (C = chunk bucket); p0: chunk start; chunk_len:
        valid tokens in the chunk (each a host int or a 0-d device
        tensor: a CUDA graph's runtime arguments); block_table:
        [n_blocks] covering at least ``p0 + C`` positions. Returns
        (logits [C, V], k_pools, v_pools)."""
        C = tokens.shape[1]
        dev = tokens.device
        gpos = torch.arange(C, device=dev) + p0
        # padded tail rows can run past the position table: clamp the
        # lookup. Their embeddings are zeroed below and their K/V lands
        # beyond the live length, where the mask keeps it dark
        x = (params["tok"][tokens[0]]
             + params["pos"][gpos.clamp(0, self.max_seq_len - 1)])
        row_mask = (torch.arange(C, device=dev) < chunk_len).to(x.dtype)
        x = (x * row_mask[:, None])[None]
        for blk, bp, kc, vc in zip(self.blocks, params["blocks"],
                                   k_pools, v_pools):
            x, _, _ = blk.apply_prefill_paged(bp, x, kc, vc, block_table,
                                              p0, chunk_len)
        x = layer_norm(x[0], params["lnf_g"], params["lnf_b"])
        return x @ params["head"], k_pools, v_pools

    def forward_verify(self, params, tokens, p0, chunk_len, k_caches,
                       v_caches, slot):
        """A speculative verify span against the dense slot caches, the
        slot-backend sibling of :meth:`forward_prefill_chunk`
        (``serving/speculative.py`` scores a draft's proposals with it
        in one causal pass): the chunk path's embedding and row mask,
        each block's ``apply_verify`` on ``slot``'s panel.

        tokens: [1, C] (C = verify bucket); p0: span start; chunk_len:
        valid tokens (host ints or 0-d device tensors); slot: the cache
        row (a host int or a 1-element device tensor). Returns (logits
        [C, V], k_caches, v_caches), the caches written IN PLACE."""
        C = tokens.shape[1]
        dev = tokens.device
        gpos = torch.arange(C, device=dev) + p0
        x = (params["tok"][tokens[0]]
             + params["pos"][gpos.clamp(0, self.max_seq_len - 1)])
        row_mask = (torch.arange(C, device=dev) < chunk_len).to(x.dtype)
        x = (x * row_mask[:, None])[None]
        for blk, bp, kc, vc in zip(self.blocks, params["blocks"],
                                   k_caches, v_caches):
            x, _, _ = blk.apply_verify(bp, x, kc, vc, slot, p0, chunk_len)
        x = layer_norm(x[0], params["lnf_g"], params["lnf_b"])
        return x @ params["head"], k_caches, v_caches

    def logits(self, tokens) -> torch.Tensor:
        """Uncached full-sequence logits (tests; the serving path never
        calls this)."""
        if self._params is None:
            self.init()
        tokens = torch.as_tensor(tokens, dtype=torch.long,
                                 device=self.device)
        with torch.inference_mode():
            return self.forward_prefill(self._params, tokens)[0]

    def forward(self, tokens) -> torch.Tensor:
        return self.logits(tokens)


def quantize_mlp_weights(model: CausalTransformerLM) -> CausalTransformerLM:
    """Convert every block's MLP weights (W1, W2) to int8 weight-only
    :class:`~deeplearning4j_tpu_torch.kernels.kv_quant.QuantWeight`
    matrices in place (per-output-channel scales; biases, attention
    projections and norms stay f32). ``TransformerEncoderLayer._mlp``
    takes either. Idempotent; returns the model (counterpart of the JAX
    ``quantize_mlp_weights``)."""
    from ..kernels.kv_quant import QuantWeight, quantize_weight
    if model._params is None:
        model.init()
    for bp in model._params["blocks"]:
        for name in ("W1", "W2"):
            if not isinstance(bp[name], QuantWeight):
                bp[name] = quantize_weight(bp[name])
    return model


def make_draft_lm(target: CausalTransformerLM, d_model: int = 32,
                  n_layers: int = 1, n_heads: int = 2,
                  d_ff: Optional[int] = None,
                  seed: Optional[int] = None) -> CausalTransformerLM:
    """A narrow, shallow draft LM for speculative decoding
    (``serving/speculative.py``; counterpart of the JAX
    ``make_draft_lm``) on the target's device, sharing its token space:
    the same vocab, ``eos_id`` and position-table reach, so every
    proposal is a legal target token and the draft's cursor tracks the
    target's positions one for one. Initialised; pass it to
    ``GenerationEngine(draft_model=...)``. ``seed`` defaults to
    ``target.seed + 1``: a same-seed, same-config draft would be the
    target itself (an identity-test rig, not a draft)."""
    draft = CausalTransformerLM(
        vocab_size=target.vocab_size, d_model=d_model, n_layers=n_layers,
        n_heads=n_heads, d_ff=d_ff, max_seq_len=target.max_seq_len,
        eos_id=target.eos_id,
        seed=target.seed + 1 if seed is None else seed,
        device=target.device)
    return draft.init()

