"""The dense decoder: the port's `TransformerConfig` with no experts, as the
benchmark builds, counts and checks it (the family contract:
families/__init__.py).

Sizes: eight keys of the published config.json map onto the port's config
(`SHAPE_KEYS`); a few more are read only to refuse what the port's decoder
cannot express (`CHECKED`) or carry no shape (`NEUTRAL`); any other key is
refused by name, so a config of another kind of model is never measured
as a dense one.

The arithmetic is copied from the port's `training_operator_tpu_torch/
trainer/bench.py`, so that a change to the port cannot move the yardstick
it is measured by: `FLOPS_RULE`, `flops_per_step` (bench.py:154-166), with
the parameter count of `_count_params` (bench.py:141-151) taken from shapes
here, so no model has to be built to count; `attention_work`
(bench.py:491-505).

The plain reference (`loss`), written from the equations and importing
nothing of the port:

- x = embed[tokens]; per layer, pre-RMSNorm (the configuration's eps, scale
  w) attention and SwiGLU MLP with residuals: q, k, v = h wq, h wk, h wv;
  split-half rotary embedding at positions 0..S-1 with `rope_theta`;
  causal softmax attention at scale D_h^-1/2, query head j reading kv head
  j // (H / KV); x += attn wo; x += (silu(h2 w1) * (h2 w3)) w2;
- the final RMSNorm, logits = h lm_head, and the mean over every token of
  logsumexp(logits) - logits[target].

It fits beside nothing else: each layer keeps only its input, its q, k
and v and its attention output (the port's `save_attn_qkv`), and
recomputes its products in backward; attention runs in blocks of queries,
each block checkpointed; the head and its cross-entropy run in blocks of
rows.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# The port's RMSNorm epsilon in every norm (trainer/model.py `_rms_norm`),
# which takes none from a config: a configuration's `run.rms_norm_eps`
# states it, whatever its published config says.
PORT_RMS_EPS = 1e-6
# The published config.json keys the port's decoder is built from.
SHAPE_KEYS = {
    "vocab_size": "vocab_size",
    "hidden_size": "d_model",
    "num_hidden_layers": "n_layers",
    "num_attention_heads": "n_heads",
    "num_key_value_heads": "n_kv_heads",
    "intermediate_size": "d_ff",
    "max_position_embeddings": "max_seq_len",
    "rope_theta": "rope_theta",
}
# Published keys read only to refuse what the port's decoder cannot express:
# (the values it can, what it is instead).
CHECKED = {
    "hidden_act": (("silu",), "the port's MLP is SwiGLU (silu)"),
    "tie_word_embeddings": ((False, None), "the port's head is untied"),
    "sliding_window": ((None,), "the port's attention is full causal, with no window"),
    "attention_bias": ((False, None), "the port's products have no biases"),
    "mlp_bias": ((False, None), "the port's products have no biases"),
    "bias": ((False, None), "the port's products have no biases"),
    "rope_scaling": ((None,), "the port's rotary embedding is unscaled"),
    "attention_dropout": ((0, 0.0), "the port's attention has no dropout"),
}
# Published keys that set no shape and no arithmetic of the step: names,
# token ids, the checkpoint's init and dtype; the RMSNorm eps, which the
# run's `rms_norm_eps` states instead.
NEUTRAL = {"architectures", "model_type", "bos_token_id", "eos_token_id", "pad_token_id",
           "initializer_range", "torch_dtype", "transformers_version", "use_cache",
           "rms_norm_eps"}
NORMS = ("layers.ln1", "layers.ln2", "ln_f")

FLOPS_RULE = ("6 x active params per token (the embedding gather excluded; for MoE one "
              "expert's MLP per token, capacity padding and dropped tokens not counted) "
              "+ 6 x n_layers x seq x d_model causal attention")

# fp32 bytes one block of attention scores may take.
SCORE_BYTES = 1 << 30
# Rows of the head's logits computed at once.
HEAD_ROWS = 2048


def dims(config: dict) -> Dict:
    """The port's TransformerConfig sizes from a configuration file,
    refusing what the port's dense decoder cannot express."""
    c = config["config"]
    unknown = sorted(set(c) - set(SHAPE_KEYS) - set(CHECKED) - NEUTRAL - {"head_dim"})
    if unknown:
        raise ValueError(f"config {config.get('name')}: the dense decoder cannot express "
                         f"{unknown}; name the family that can (\"family\")")
    missing = [k for k in SHAPE_KEYS if k not in c]
    if missing:
        raise ValueError(f"config {config.get('name')} lacks {missing}")
    for key, (allowed, why) in CHECKED.items():
        if key in c and c[key] not in allowed:
            raise ValueError(f"{key} {c[key]!r}: {why}")
    if config["run"].get("rms_norm_eps") != PORT_RMS_EPS:
        raise ValueError(f"the port runs RMSNorm at eps {PORT_RMS_EPS}: run.rms_norm_eps "
                         "has to state it")
    out = {ours: c[theirs] for theirs, ours in SHAPE_KEYS.items()}
    head_dim = c.get("head_dim", c["hidden_size"] // c["num_attention_heads"])
    if head_dim * c["num_attention_heads"] != c["hidden_size"]:
        raise ValueError("the port's head_dim is hidden_size / num_attention_heads")
    return out


def port_config(dims: dict, run: dict):
    """The port's TransformerConfig as the cell runs it."""
    from training_operator_tpu_torch.trainer.model import TransformerConfig

    return TransformerConfig(**dims, dtype=getattr(torch, run["dtype"]), remat=True,
                             remat_policy=run["remat_policy"], remat_head=run["remat_head"])


def param_shapes(dims: dict) -> Dict[str, tuple]:
    """Every parameter of the dense decoder by the port's names and layout:
    per-layer weights stacked on a leading [L] axis, matrices [in, out]."""
    dm, dff, L, V = dims["d_model"], dims["d_ff"], dims["n_layers"], dims["vocab_size"]
    hd = dm // dims["n_heads"]
    q_dim, kv_dim = dims["n_heads"] * hd, dims["n_kv_heads"] * hd
    return {
        "embed": (V, dm),
        "layers.ln1": (L, dm), "layers.wq": (L, dm, q_dim), "layers.wk": (L, dm, kv_dim),
        "layers.wv": (L, dm, kv_dim), "layers.wo": (L, q_dim, dm), "layers.ln2": (L, dm),
        "layers.w1": (L, dm, dff), "layers.w3": (L, dm, dff), "layers.w2": (L, dff, dm),
        "ln_f": (dm,), "lm_head": (dm, V),
    }


def count_params(dims: dict) -> tuple:
    """(total, in products): the embedding table is a gather, not a product
    (`_count_params` for a dense model)."""
    sizes = {n: math.prod(s) for n, s in param_shapes(dims).items()}
    total = sum(sizes.values())
    return total, total - sizes["embed"]


def leaf_init(dims: dict, name: str) -> Optional[float]:
    """The port's init (`init_params`): N(0, 1) embedding, N(0, D^-1/2)
    products, the residual outputs (wo, w2) at D^-1/2 / sqrt(2L); norm
    scales at ones (None)."""
    if name in NORMS:
        return None
    if name == "embed":
        return 1.0
    std = dims["d_model"] ** -0.5
    if name in ("layers.wo", "layers.w2"):
        return std / (2 * dims["n_layers"]) ** 0.5
    return std


def flops_per_step(dims: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one fwd+bwd step (FLOPS_RULE): 6*N per token for
    weight products plus causal self-attention 6*L*S*d_model per token (no
    remat recompute)."""
    tokens = batch * seq
    attn = 6 * dims["n_layers"] * seq * dims["d_model"]
    return float(tokens) * (6.0 * count_params(dims)[1] + attn)


def attention_work(batch: int, seq: int, heads: int, head_dim: int, causal: bool,
                   dtype_bytes: int = 2) -> Dict[str, Dict[str, float]]:
    """FLOPs and bytes each flash kernel must do on these shapes: the (q, k)
    pairs the mask keeps, 2*D FLOP per pair per product; each input read once
    and each output written once (tensors of `dtype_bytes` a value, fp32
    lse/delta)."""
    bh = batch * heads
    pairs = bh * (seq * (seq + 1) // 2 if causal else seq * seq)
    tensor = bh * seq * head_dim * dtype_bytes
    rows = bh * seq * 4
    return {
        "flash_fwd": {"flops": 2 * 2 * head_dim * pairs, "bytes": 4 * tensor + rows},
        "flash_bwd_dq": {"flops": 3 * 2 * head_dim * pairs, "bytes": 5 * tensor + 2 * rows},
        "flash_bwd_dkv": {"flops": 4 * 2 * head_dim * pairs, "bytes": 6 * tensor + 2 * rows},
    }


def attention_bound_s(dims: dict, batch: int, seq: int, dtype_bytes: int, calls: dict,
                      flops_peak: float, bytes_peak: float) -> float:
    """Every layer's attention has the one shape: each call is bound by the
    larger of its FLOPs at `flops_peak` and its bytes at `bytes_peak`."""
    work = attention_work(batch, seq, dims["n_heads"], dims["d_model"] // dims["n_heads"], True,
                          dtype_bytes)
    return sum(len(ids) * max(work[op]["flops"] / flops_peak, work[op]["bytes"] / bytes_peak)
               for op, ids in calls.items())


def _rope(x, theta: float, shape):
    """Split-half rotary embedding of x viewed as [b, s, h, d], at positions
    0..s-1."""
    x = x.reshape(shape)
    s, d = x.shape[1], x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attn_block(q, k, v, start: int, prec):
    """Causal attention of queries [start, start + bq) against keys
    [0, start + bq): q [b, bq, kv, rep, d], k and v [b, n, kv, d]."""
    d = q.shape[-1]
    n = k.shape[1]
    scores = torch.einsum("bqgrd,bkgd->bgrqk", prec.body(q), prec.body(k)) * d ** -0.5
    rows = torch.arange(start, start + q.shape[1], device=q.device)[:, None]
    cols = torch.arange(n, device=q.device)[None, :]
    scores = scores.masked_fill(cols > rows, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bgrqk,bkgd->bqgrd", prec.body(p), prec.body(v))


def attention(q, k, v, prec):
    """q [b, s, H, d], k and v [b, s, KV, d] -> [b, s, H, d]."""
    b, s, H, d = q.shape
    kv = k.shape[2]
    q = q.reshape(b, s, kv, H // kv, d)
    bq = max(16, min(s, 2 ** int(math.log2(max(1, SCORE_BYTES // (b * H * s * 4))))))
    outs = []
    for start in range(0, s, bq):
        end = min(s, start + bq)
        outs.append(checkpoint(_attn_block, q[:, start:end], k[:, :end], v[:, :end],
                               start, prec, use_reentrant=False))
    return torch.cat(outs, dim=1).reshape(b, s, H, d)


def _qkv(x, lp: Dict[str, torch.Tensor], dims: dict, prec):
    b, s, D = x.shape
    H, KV = dims["n_heads"], dims["n_kv_heads"]
    d = D // H
    h = prec.rms(x, lp["ln1"])
    q = _rope(prec.body(h) @ prec.body(lp["wq"]), dims["rope_theta"], (b, s, H, d))
    k = _rope(prec.body(h) @ prec.body(lp["wk"]), dims["rope_theta"], (b, s, KV, d))
    v = (prec.body(h) @ prec.body(lp["wv"])).reshape(b, s, KV, d)
    return q, k, v


def _out_mlp(x, attn, lp: Dict[str, torch.Tensor], prec):
    mm = lambda a, w: prec.body(a) @ prec.body(w)  # noqa: E731
    x = x + mm(attn.reshape(x.shape), lp["wo"])
    h = prec.rms(x, lp["ln2"])
    return x + mm(F.silu(mm(h, lp["w1"])) * mm(h, lp["w3"]), lp["w2"])


def layer(x, lp: Dict[str, torch.Tensor], dims: dict, prec):
    """One decoder layer. The products before and after attention are
    recomputed in backward; attention keeps its inputs and output and
    recomputes only its scores, block by block."""
    q, k, v = checkpoint(_qkv, x, lp, dims, prec, use_reentrant=False)
    return checkpoint(_out_mlp, x, attention(q, k, v, prec), lp, prec, use_reentrant=False)


def _head_sum(h, lm_head, targets, prec):
    logits = prec.head(h) @ prec.head(lm_head)
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, targets[:, None]).squeeze(-1)).sum()


def head_loss(x, params: Dict[str, torch.Tensor], targets, prec, half_batch: bool = False):
    """The final norm, the head and the mean cross-entropy of x [b, s, D]
    (over the first half of the tokens with `half_batch`)."""
    h = prec.rms(x, params["ln_f"]).reshape(-1, x.shape[-1])
    t = targets.reshape(-1)
    n = t.numel() // 2 if half_batch else t.numel()
    total = sum(checkpoint(_head_sum, h[i:min(n, i + HEAD_ROWS)], params["lm_head"],
                           t[i:min(n, i + HEAD_ROWS)], prec, use_reentrant=False)
                for i in range(0, n, HEAD_ROWS))
    return total / n


def loss(params: Dict[str, torch.Tensor], tokens, targets, dims: dict, prec,
         half_batch: bool = False):
    """Mean next-token cross-entropy over [b, s] tokens (over the first half
    of them with `half_batch`)."""
    x = params["embed"][tokens]
    names = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w1", "w3", "w2")
    for i in range(dims["n_layers"]):
        x = layer(x, {n: params["layers." + n][i] for n in names}, dims, prec)
    return head_loss(x, params, targets, prec, half_batch)
