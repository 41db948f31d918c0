"""OLMoE: a pre-RMSNorm decoder whose attention has qk-norm and whose every
MLP is a dropless top-k mixture of experts (Muennighoff et al. 2024, OLMoE:
Open Mixture-of-Experts Language Models, arXiv:2409.02060; transformers'
`modeling_olmoe.py`), as the benchmark builds, counts and checks it on the
port's `TransformerConfig` with `moe_router="dropless"` and `qk_norm` (the
family contract: families/__init__.py).

Sizes: the dense decoder's shape keys (families/decoder.py) and four of
the expert layer's; the RMSNorm eps, which the port takes from the config
and which the run block has to state as published. Any other key is
refused by name, as are `norm_topk_prob` true, a non-null `clip_qkv` and a
`rope_scaling`.

The plain reference (`loss`), written from the equations and importing
nothing of the port; the decoder family's attention, rotary embedding and
head are reused, loaded by path:

- x = embed[tokens]; per layer, with h = RMSNorm(x):
  q = RMSNorm_q(h wq), k = RMSNorm_k(h wk), each over the whole projection
  (all heads at once), then split-half RoPE; v = h wv; causal softmax
  attention; x += attn wo;
- h2 = RMSNorm(x); p = softmax(h2 w_router) over the E experts; the k
  largest p of each token are its gates, not renormalised; x += sum over
  the token's k experts of gate * SwiGLU_e(h2), every expert's rows
  computed (no capacity, no token dropped), as transformers'
  `OlmoeSparseMoeBlock` loops over its experts;
- the final RMSNorm, the head and the mean cross-entropy, plus
  `router_aux_coef` times transformers' `load_balancing_loss_func` over
  every layer's router: E * sum_e (C_e / (L T)) * (P_e / (L T)), C_e the
  (token, choice) pairs of every layer that chose e, P_e the sum of e's
  probability over every layer's tokens.

Every weight product of the layers goes through `Numerics.body`; the router
product, which the port runs in fp32 as it runs the head, goes through
`Numerics.head` with the head's.

The expert work (`expert_bound_s`) is exact: the layer is dropless and
holds every expert, so each layer computes T k rows a step.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark import families

decoder = families.load(Path(__file__).resolve().parents[2], "decoder")

# The expert layer's published keys, and the port's names for them.
MOE_KEYS = {
    "num_experts": "n_experts",
    "num_experts_per_tok": "n_experts_per_tok",
    "router_aux_loss_coef": "router_aux_coef",
    "rms_norm_eps": "rms_norm_eps",
}
# Published keys read only to refuse what the port cannot express.
CHECKED = {
    **decoder.CHECKED,
    "norm_topk_prob": ((False,), "the gates of the port's run are not renormalised"),
    "clip_qkv": ((None,), "the port does not clip q, k and v"),
}
# Published keys that set no shape and no arithmetic of the step. Training
# adds the load-balancing loss whatever `output_router_logits` says (the
# checkpoint's default for inference).
NEUTRAL = decoder.NEUTRAL - {"rms_norm_eps"} | {"output_router_logits"}
NORMS = ("layers.ln1", "layers.ln2", "layers.q_norm", "layers.k_norm", "ln_f")
EXPERTS = ("layers.w1", "layers.w3", "layers.w2")
NAMES = ("ln1", "wq", "wk", "wv", "q_norm", "k_norm", "wo", "ln2", "router")


def dims(config: dict) -> Dict:
    """The port's sizes from an OLMoE configuration file."""
    c = config["config"]
    known = set(decoder.SHAPE_KEYS) | set(MOE_KEYS) | set(CHECKED) | NEUTRAL | {"head_dim"}
    unknown = sorted(set(c) - known)
    if unknown:
        raise ValueError(f"config {config.get('name')}: the OLMoE family cannot express "
                         f"{unknown}")
    missing = [k for k in (*decoder.SHAPE_KEYS, *MOE_KEYS) if k not in c]
    if missing:
        raise ValueError(f"config {config.get('name')} lacks {missing}")
    for key, (allowed, why) in CHECKED.items():
        if key in c and c[key] not in allowed:
            raise ValueError(f"{key} {c[key]!r}: {why}")
    run = config["run"]
    if run.get("rms_norm_eps") != c["rms_norm_eps"]:
        raise ValueError(f"the port runs RMSNorm at the published eps {c['rms_norm_eps']}: "
                         "run.rms_norm_eps has to state it")
    if run.get("router_aux_coef") != c["router_aux_loss_coef"]:
        raise ValueError("training adds the load-balancing loss at the published "
                         f"{c['router_aux_loss_coef']}: run.router_aux_coef has to state it")
    if c.get("head_dim", c["hidden_size"] // c["num_attention_heads"]) \
            * c["num_attention_heads"] != c["hidden_size"]:
        raise ValueError("the port's head_dim is hidden_size / num_attention_heads")
    out = {ours: c[theirs] for theirs, ours in decoder.SHAPE_KEYS.items()}
    out.update({ours: c[theirs] for theirs, ours in MOE_KEYS.items()})
    return out


def port_config(dims: dict, run: dict):
    """The port's TransformerConfig as the cell runs it."""
    from training_operator_tpu_torch.trainer.model import TransformerConfig

    shape = {k: dims[k] for k in decoder.SHAPE_KEYS.values()}
    return TransformerConfig(**shape, dtype=getattr(torch, run["dtype"]), remat=True,
                             remat_policy=run["remat_policy"], remat_head=run["remat_head"],
                             n_experts=dims["n_experts"],
                             n_experts_per_tok=dims["n_experts_per_tok"],
                             moe_router="dropless", qk_norm=True,
                             router_aux_coef=dims["router_aux_coef"],
                             rms_norm_eps=dims["rms_norm_eps"])


def param_shapes(dims: dict) -> Dict[str, tuple]:
    """Every parameter by the port's names and layout: the decoder's, qk-norm's
    scales, the router [L, D, E] and the expert stacks [L, E, in, out]."""
    L, D, F_, E = dims["n_layers"], dims["d_model"], dims["d_ff"], dims["n_experts"]
    kv_dim = dims["n_kv_heads"] * (D // dims["n_heads"])
    return {**decoder.param_shapes(dims), "layers.q_norm": (L, D), "layers.k_norm": (L, kv_dim),
            "layers.router": (L, D, E), "layers.w1": (L, E, D, F_), "layers.w3": (L, E, D, F_),
            "layers.w2": (L, E, F_, D)}


def count_params(dims: dict) -> tuple:
    """(total, in the products a token passes through): all but the
    embedding, of the experts only the k a token is sent to."""
    sizes = {n: math.prod(s) for n, s in param_shapes(dims).items()}
    total = sum(sizes.values())
    experts = sum(sizes[n] for n in EXPERTS)
    idle = experts - experts * dims["n_experts_per_tok"] // dims["n_experts"]
    return total, total - sizes["embed"] - idle


def leaf_init(dims: dict, name: str) -> Optional[float]:
    """The port's init: norm scales at ones (None); the router and experts'
    input products at D^-1/2 and w2 at the residual std, as the decoder's."""
    if name in NORMS:
        return None
    return decoder.leaf_init(dims, name)


def flops_per_step(dims: dict, batch: int, seq: int) -> float:
    """6 x (attention products + router + the k experts' SwiGLU + head) per
    token, plus the decoder's causal-attention term, 6 L S D per token."""
    attn = 6 * dims["n_layers"] * seq * dims["d_model"]
    return float(batch * seq) * (6.0 * count_params(dims)[1] + attn)


attention_bound_s = decoder.attention_bound_s


def expert_work(dims: dict, batch: int, seq: int, dtype_bytes: int) -> Dict[str, float]:
    """FLOPs and bytes of one layer's grouped SwiGLU products over its T k
    rows, in the forward (or its recompute): three products of 2 T k D F
    FLOPs; the expert weights read once, the rows read in and written out
    once. Its backward does twice both."""
    rows = batch * seq * dims["n_experts_per_tok"]
    D, F_, E = dims["d_model"], dims["d_ff"], dims["n_experts"]
    return {"flops": 2.0 * rows * 3 * D * F_,
            "bytes": float(dtype_bytes) * (3 * E * D * F_ + 2 * rows * D)}


def expert_bound_s(dims: dict, batch: int, seq: int, dtype_bytes: int, calls: dict,
                   flops_peak: float, bytes_peak: float) -> float:
    """The least seconds the card could take for a window's calls of the
    expert products, `calls` {"forward": n, "backward": m} (forward and
    recompute, backward): each call the larger of its FLOPs at `flops_peak`
    and its bytes at `bytes_peak`."""
    w = expert_work(dims, batch, seq, dtype_bytes)
    one = max(w["flops"] / flops_peak, w["bytes"] / bytes_peak)
    return one * (calls.get("forward", 0) + 2 * calls.get("backward", 0))


def _qkv(x, lp: Dict[str, torch.Tensor], dims: dict, prec):
    b, s, D = x.shape
    H, KV = dims["n_heads"], dims["n_kv_heads"]
    d, theta = D // H, dims["rope_theta"]
    h = prec.rms(x, lp["ln1"])
    q = prec.rms(prec.body(h) @ prec.body(lp["wq"]), lp["q_norm"])
    k = prec.rms(prec.body(h) @ prec.body(lp["wk"]), lp["k_norm"])
    v = (prec.body(h) @ prec.body(lp["wv"])).reshape(b, s, KV, d)
    return decoder._rope(q, theta, (b, s, H, d)), decoder._rope(k, theta, (b, s, KV, d)), v


def route(h, router, dims: dict, prec):
    """h [T, D] -> (probs [T, E], gate [T, k], choice [T, k])."""
    probs = torch.softmax(prec.head(h) @ prec.head(router), dim=-1)
    gate, choice = probs.topk(dims["n_experts_per_tok"], dim=-1)
    return probs, gate, choice


class _Pick(torch.autograd.Function):
    """`stack[index]`, a view of a parameter stack; its backward adds the
    gradient into the stack's `.grad` in place (zeros at first use) and hands
    autograd none. Indexing would hand autograd a zero-filled gradient of the
    whole stack for every layer and expert (4 GiB for an expert stack at the
    cell's size), which does not fit beside the model's state."""

    @staticmethod
    def forward(ctx, stack, *index):
        ctx.stack, ctx.index = stack, index
        return stack[index]

    @staticmethod
    def backward(ctx, grad):
        stack = ctx.stack
        if stack.grad is None:
            stack.grad = torch.zeros_like(stack)
        stack.grad[ctx.index] += grad
        return (None,) * (1 + len(ctx.index))


def _expert(h, tok, gate, w1, w3, w2, prec):
    """gate * SwiGLU(h[tok]) of one expert's rows."""
    mm = lambda a, w: prec.body(a) @ prec.body(w)  # noqa: E731
    he = h[tok]
    return gate[:, None] * mm(F.silu(mm(he, w1)) * mm(he, w3), w2)


def _out_moe(x, attn, lp: Dict[str, torch.Tensor], experts, dims: dict, prec):
    """The output projection, then the dropless expert layer: (x, the
    layer's [2, E] stack of pairs and probability sums per expert). Each
    expert's rows are recomputed in backward from h."""
    x = x + prec.body(attn.reshape(x.shape)) @ prec.body(lp["wo"])
    b, s, D = x.shape
    h = prec.rms(x, lp["ln2"]).reshape(-1, D)
    probs, gate, choice = route(h, lp["router"], dims, prec)
    out = torch.zeros_like(h)
    for e, (w1, w3, w2) in enumerate(experts):
        tok, slot = (choice == e).nonzero(as_tuple=True)
        y = checkpoint(_expert, h, tok, gate[tok, slot], w1, w3, w2, prec, use_reentrant=False)
        out = out.index_add(0, tok, y)
    counts = torch.bincount(choice.reshape(-1), minlength=dims["n_experts"]).float()
    return x + out.reshape(b, s, D), torch.stack([counts, probs.sum(0)])


def layer(x, lp: Dict[str, torch.Tensor], experts, dims: dict, prec):
    """One layer: (x, its [2, E] stack). The products before and after
    attention are recomputed in backward; attention keeps its inputs and
    output and recomputes only its scores, block by block."""
    q, k, v = checkpoint(_qkv, x, lp, dims, prec, use_reentrant=False)
    return checkpoint(_out_moe, x, decoder.attention(q, k, v, prec), lp, experts, dims, prec,
                      use_reentrant=False)


def balance_loss(sums, tokens: int, dims: dict):
    """transformers' load_balancing_loss_func over the layers' summed
    stacks."""
    rows = dims["n_layers"] * tokens
    return dims["n_experts"] * ((sums[0] / rows) * (sums[1] / rows)).sum()


def loss(params: Dict[str, torch.Tensor], tokens, targets, dims: dict, prec,
         half_batch: bool = False):
    """Mean next-token cross-entropy over [b, s] tokens (over the first half
    of them with `half_batch`) plus the weighted load-balancing loss."""
    x = params["embed"][tokens]
    sums = 0.0
    for i in range(dims["n_layers"]):
        lp = {n: _Pick.apply(params["layers." + n], i) for n in NAMES}
        experts = [tuple(_Pick.apply(params["layers." + n], i, e) for n in ("w1", "w3", "w2"))
                   for e in range(dims["n_experts"])]
        x, s = layer(x, lp, experts, dims, prec)
        sums = sums + s
    ce = decoder.head_loss(x, params, targets, prec, half_batch)
    return ce + dims["router_aux_coef"] * balance_loss(sums, tokens.numel(), dims)
