"""SE(3) pose-diffusion denoiser transformer (port of
``puzzlefusion_plusplus_tpu/models/denoiser.py``).

Dropout sits where the JAX model has it (attention outputs, the GEGLU feed-forward, the
per-part position encoding); it is active in ``train()`` mode only.

Parameters carry the original repo's keys (``transformer_layers.{i}.norm1.emb``,
``...self_attn.to_q``, ``...to_out.0``, ``...ff.net.0.proj``, ``mlp_out_trans.{0,2,4}``), which
``convert/torch_ckpt.py::convert_denoiser`` reads. The attention masks are additive -1e9
biases applied before a plain softmax, exactly as the JAX package builds them; a boolean
mask through ``scaled_dot_product_attention`` would treat fully masked rows differently.

``dtype=torch.bfloat16`` (``trainer.precision=bf16``) computes as the JAX model with
``dtype=jnp.bfloat16`` does, module by module, with flax's casts and not autocast's op lists:
every Dense and Embed casts its input and its fp32 parameters to bf16 and rounds the product
and then the bias add to bf16; the LayerNorms and the softmax compute in fp32; the reference
part's table and the last layer of each pose head have no dtype and stay fp32, so the
residual stream stays fp32 while every Dense takes bf16 inputs (torch promotes bf16 + fp32 to
fp32 as jnp does). Where the JAX model promotes a bf16 op's result to fp32 right away, XLA
computes that op in fp32 and never rounds it (the scores q k^T, the bias add of a Dense whose
output joins the residual stream, ``1 + scale`` of the AdaLN): the port does the same
(``dense(..., promoted=True)``), and computes silu and gelu in bf16 op by op as XLA lowers
them. The parameters, their gradients and the optimizer's state stay fp32.

On the card, ``DenoiserTransformer.forward`` replays its inference forward from a CUDA graph
(one a shape of the inputs), so that the engine's denoising loop does not wait on the eager
dispatch of its few hundred launches a call. The graph runs the same kernels on the same
parameters as the eager body (``_forward_eager``), which every other call takes.

Where a call is fit for the graph (``_graph_key``) and the model runs in fp32 at a width that
kernel D takes (``_d_capable``), the encoder layers' linears (the fused q|k|v and the
out-projection of each attention, the GEGLU projection with its h * gelu(gate), the
feed-forward's out-projection) run on kernel D (``ops/dense.py``), 3xTF32 on the tensor cores
at FP32 accuracy, from weights split once into TF32 planes (``SplitWeights``, rebuilt in place
when a weight changes: ``_refresh_split``). The model decides this once a call and hands the
layers a ``split`` flag. Every other call, training and bf16 and the CPU included, keeps
``F.linear`` through the modules.
"""

from __future__ import annotations

import math
import sys
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.modules import module as nn_module

from puzzlefusion_plusplus_tpu_torch import ops
from puzzlefusion_plusplus_tpu_torch.models.embeddings import nerf_embed, sinusoidal_table
from puzzlefusion_plusplus_tpu_torch.ops.dense import SplitWeights
from puzzlefusion_plusplus_tpu_torch.utils import profiling

NEG_INF = -1e9
SQRT_HALF_BF16 = 0.70703125  # sqrt(1/2) rounded to bf16, as jax.nn.gelu casts it
# eager calls on a side stream before a capture, as torch.cuda.graph asks: cuBLAS's handles
# and workspaces and every lazy initialisation happen there, outside the graph
GRAPH_WARMUP_CALLS = 3


def silu(x: torch.Tensor, promoted: bool = False) -> torch.Tensor:
    """``F.silu``; in bf16 as XLA computes ``jax.nn.silu`` there, each op rounded to bf16:
    x * (1 / (1 + exp(-x))), the last product in fp32 and returned so when ``promoted``."""
    if x.dtype == torch.float32:
        return F.silu(x)
    sig = 1 / (1 + torch.exp(-x))
    return x.float() * sig.float() if promoted else x * sig


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact ``F.gelu``; in bf16 as XLA computes ``jax.nn.gelu(approximate=False)`` there:
    (0.5 x) rounded, times erfc(-x sqrt(1/2)) evaluated in fp32 and rounded."""
    if x.dtype == torch.float32:
        return F.gelu(x)
    return (0.5 * x) * torch.erfc(x.float() * -SQRT_HALF_BF16).to(x.dtype)


def dense(x, layer: nn.Module, dtype: torch.dtype | None = None, promoted: bool = False):
    """``layer(x)``, or with ``dtype`` as flax's ``nn.Dense(dtype=dtype)`` computes it over the
    last axis: the input, kernel (an ``nn.Linear``'s, or a 1x1 conv's) and bias cast to
    ``dtype``, the product rounded, then the bias added and rounded. ``promoted``: the JAX
    model promotes the output to fp32 at once, so XLA adds the bias in fp32 and the result
    stays fp32 (see the module note)."""
    if dtype is None:
        return layer(x)  # through the module, whose hooks tensor parallelism installs
    y = F.linear(x.to(dtype), layer.weight.flatten(1).to(dtype))
    if layer.bias is None:
        return y.float() if promoted else y
    b = layer.bias.to(dtype)
    return y.float() + b.float() if promoted else y + b


class AdaLayerNorm(nn.Module):
    """LayerNorm modulated by a learned per-timestep scale/shift."""

    def __init__(self, dim: int, num_embeddings: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.emb = nn.Embedding(num_embeddings, dim)
        self.linear = nn.Linear(dim, 2 * dim)

    def forward(self, x, timestep):
        dt = self.dtype
        emb = self.emb(timestep) if dt is None else self.emb.weight.to(dt)[timestep]
        scale, shift = dense(silu(emb), self.linear, dt).chunk(2, dim=-1)
        x = F.layer_norm(x, x.shape[-1:], eps=1e-5)  # fp32 statistics, as flax's
        return x * (1.0 + scale.float()[:, None, :]) + shift[:, None, :]


def attention(q, k, v, heads: int, bias, dropout: float = 0.0):
    """q/k/v [B, T, C] -> [B, T, C]: softmax(q k^T / sqrt(hd) + bias) v per head, with
    dropout of rate ``dropout`` on the probabilities (callers pass 0 outside training). The
    scores and the softmax are fp32 whatever the inputs' dtype (XLA folds the JAX model's
    upcast of its bf16 q k^T into the product, so the scores are never rounded to bf16); the
    probabilities return to the inputs' dtype before the product with v."""
    B, T, C = q.shape
    hd = C // heads
    q, k, v = (t.reshape(B, T, heads, hd).transpose(1, 2) for t in (q, k, v))
    scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(hd)
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    if dropout:
        probs = F.dropout(probs, dropout, training=True)
    out = probs @ v
    return out.transpose(1, 2).reshape(B, T, C)


class Attention(nn.Module):
    """diffusers-style attention: biasless q/k/v, biased out-projection ``to_out.0``. With
    ``split``, q, k and v are views of one product of D with the three weights' planes."""

    def __init__(self, dim: int, heads: int, dropout: float = 0.0,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(dim, dim, bias=False)
        self.to_v = nn.Linear(dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim), nn.Dropout(dropout)])
        self._qkv = SplitWeights((self.to_q, self.to_k, self.to_v))
        self._out = SplitWeights((self.to_out[0],))

    def forward(self, x, bias, split: bool = False):
        if split:
            q, k, v = self._qkv(x).chunk(3, dim=-1)
            return self._out(attention(q, k, v, self.heads, bias))
        q, k, v = (dense(x, lin, self.dtype) for lin in (self.to_q, self.to_k, self.to_v))
        out = attention(q, k, v, self.heads, bias)
        return self.to_out[1](dense(out, self.to_out[0], self.dtype, promoted=True))


class GEGLU(nn.Module):
    """h * gelu(gate) of one projection; with ``split`` D's epilogue computes it."""

    def __init__(self, dim: int, inner: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Linear(dim, 2 * inner)
        self._split = SplitWeights((self.proj,), geglu=True)

    def forward(self, x, split: bool = False):
        if split:
            return self._split(x)
        h, gate = dense(x, self.proj, self.dtype).chunk(2, dim=-1)
        return h * gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.net = nn.ModuleList([GEGLU(dim, dim * mult, dtype), nn.Dropout(dropout),
                                  nn.Linear(dim * mult, dim)])
        self._split = SplitWeights((self.net[2],))

    def forward(self, x, split: bool = False):
        if split:
            return self._split(self.net[1](self.net[0](x, split)))
        return dense(self.net[1](self.net[0](x)), self.net[2], self.dtype, promoted=True)


class EncoderLayer(nn.Module):
    """AdaLN -> part-local attention -> AdaLN -> global attention -> LN -> GEGLU FF."""

    def __init__(self, dim: int, heads: int, num_ada: int, dropout: float = 0.0,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.norm1 = AdaLayerNorm(dim, num_ada, dtype)
        self.self_attn = Attention(dim, heads, dropout, dtype)
        self.norm2 = AdaLayerNorm(dim, num_ada, dtype)
        self.global_attn = Attention(dim, heads, dropout, dtype)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim, dropout=dropout, dtype=dtype)

    def forward(self, x, self_bias, gen_bias, timestep, split: bool = False):
        """``split``: the linears on kernel D (``DenoiserTransformer._forward_eager``)."""
        x = x + self.self_attn(self.norm1(x, timestep), self_bias, split)
        x = x + self.global_attn(self.norm2(x, timestep), gen_bias, split)
        return x + self.ff(self.norm3(x), split)


def _pose_head(dim: int, out: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(dim, dim), nn.SiLU(), nn.Linear(dim, dim // 2), nn.SiLU(),
                         nn.Linear(dim // 2, out))


class DenoiserTransformer(nn.Module):
    def __init__(
        self,
        embed_dim: int = 512,
        num_layers: int = 6,
        num_heads: int = 8,
        num_dim: int = 64,
        max_parts: int = 20,
        multires: int = 10,
        num_ada_embeds: int = 3072,
        dropout: float = 0.2,
        pe_dropout: float = 0.1,
        dtype: torch.dtype | None = None,
    ):
        """``dtype``: the compute dtype (``torch.bfloat16`` for ``trainer.precision=bf16``,
        None for fp32); the parameters stay fp32 either way."""
        super().__init__()
        self.embed_dim = embed_dim
        self.multires = multires
        self.dtype = dtype
        self.ref_part_emb = nn.Embedding(2, embed_dim)  # no dtype in the JAX model: fp32
        self.transformer_layers = nn.ModuleList(
            [EncoderLayer(embed_dim, num_heads, num_ada_embeds, dropout, dtype)
             for _ in range(num_layers)]
        )
        self.pe_dropout = nn.Dropout(pe_dropout)
        nerf = 1 + 2 * multires
        self.shape_embedding = nn.Linear(num_dim + 3 * nerf + nerf, embed_dim)
        self.param_fc = nn.Linear(7 * nerf, embed_dim)
        self.mlp_out_trans = _pose_head(embed_dim, 3)
        self.mlp_out_rot = _pose_head(embed_dim, 4)
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_table(max_parts, embed_dim)), persistent=False
        )
        # kernel D's block shapes need N % 64 == 0 and K % 32 == 0, which every linear of the
        # layers meets where the width does; bf16 keeps flax's rounding through ``dense``
        self._d_capable = dtype is None and embed_dim % 64 == 0
        self._drop_graphs()

    def forward(self, x, timesteps, latent, xyz, part_valids, scale, ref_part):
        """x [B, P, 7], timesteps [B] int, latent [B, P, L, num_dim], xyz [B, P, L, 3],
        part_valids [B, P], scale [B, P, 1], ref_part [B, P] bool -> [B, P, 7].

        Where ``_graph_key`` finds the call fit for it (contiguous inputs on the current
        card, ``eval()``, autograd off, a plain module tree), the first call at a key
        captures ``_forward_eager`` into a CUDA graph (span ``pfpp.denoiser.capture``) and
        every call at it replays the graph on a copy of its inputs (``pfpp.denoiser.replay``)
        and returns a fresh tensor; the graph's layers run on kernel D where ``_d_capable``.
        Every other call runs ``_forward_eager`` without D."""
        args = (x, timesteps, latent, xyz, part_valids, scale, ref_part)
        key = self._graph_key(args)
        if key is None:
            return self._forward_eager(*args, split=False)
        if self._d_capable:
            self._refresh_split()  # the planes a replay reads, before the replay
        g = self._graphs.get(key)
        if g is None:
            with profiling.span("pfpp.denoiser.capture"):
                g = self._graphs[key] = self._capture(args)
        with profiling.span("pfpp.denoiser.replay"):
            for buf, a in zip(g.inputs, args):
                buf.copy_(a)
            g.graph.replay()
            for name, n in g.launches:  # the wrappers' launches that the replay ran
                ops.KERNEL_WRAPPERS[name].launches += n
            return g.output.clone()

    def _forward_eager(self, x, timesteps, latent, xyz, part_valids, scale, ref_part,
                       split=None):
        """The forward, launched op by op (``forward``'s arguments). ``split``: the encoder
        layers' linears on kernel D; by default where ``forward`` would run them there (a call
        fit for the graph, ``_d_capable``), with the planes brought up to date first."""
        if split is None:
            args = (x, timesteps, latent, xyz, part_valids, scale, ref_part)
            split = self._d_capable and self._graph_key(args) is not None
            if split:
                self._refresh_split()
        B, P, L, _ = latent.shape
        C, T = self.embed_dim, P * L
        scale_emb = nerf_embed(scale, self.multires)[:, :, None, :].expand(B, P, L, -1)
        xyz_emb = nerf_embed(xyz, self.multires)
        dt = self.dtype
        shape_emb = dense(torch.cat([latent, xyz_emb, scale_emb], dim=-1), self.shape_embedding,
                          dt, promoted=True)
        x_emb = dense(nerf_embed(x, self.multires), self.param_fc, dt, promoted=True)
        x_emb = x_emb + self.ref_part_emb.weight[ref_part.long()]  # fp32 from here on
        data = x_emb[:, :, None, :] + shape_emb + self.pe[:P][None, :, None, :]
        data = self.pe_dropout(data).reshape(B, T, C)

        part_id = torch.arange(T, device=x.device) // L
        zero = torch.zeros((), dtype=data.dtype, device=x.device)
        neg = torch.full((), NEG_INF, dtype=data.dtype, device=x.device)
        self_bias = torch.where(part_id[:, None] == part_id[None, :], zero, neg)[None, None]
        tok_valid = part_valids.bool().repeat_interleave(L, dim=1)
        gen_bias = torch.where(tok_valid, zero, neg)[:, None, None, :]
        for layer in self.transformer_layers:
            data = layer(data, self_bias, gen_bias, timesteps, split)

        out = data.reshape(B, P, L, C).mean(dim=2).float()
        return torch.cat([self._head(self.mlp_out_trans, out), self._head(self.mlp_out_rot, out)],
                         dim=-1)

    def train(self, mode: bool = True):
        """As ``nn.Module.train``; training mode also drops the captured graphs and their
        memory pool and kernel D's weight planes, so that training never holds them."""
        if mode:
            self._drop_graphs()
            for layer in self.transformer_layers:
                for split in _splits(layer):
                    split.drop()
        return super().train(mode)

    def _refresh_split(self) -> None:
        """Kernel D's weight planes brought up to date with the weights, after ``_graph_key``
        and never inside a capture: rebuilt in place where only values changed, so that the
        captured graphs read the new ones. The one watch over the planes' sources: their
        version counters against the last build's (any in-place update: an optimizer step,
        ``load_state_dict``); their addresses are ``_graph_key``'s, whose move (``.to()``,
        ``load_state_dict(assign=True)``, a rebound parameter) drops the graphs and this
        watch. A write through ``.data`` bumps no version and is not seen."""
        watch = self._split_watch
        if watch is not None and [t._version for t in watch[0]] == watch[1]:
            return
        splits = [split for layer in self.transformer_layers for split in _splits(layer)]
        for split in splits:
            split.build()
        tensors = [t for split in splits for t in split.sources()]
        self._split_watch = (tensors, [t._version for t in tensors])

    def _drop_graphs(self) -> None:
        self._graphs, self._graph_params, self._graph_pool = {}, None, None
        self._split_watch = None

    def _graph_key(self, args):
        """The key of the CUDA graph that serves a call with these inputs: their shapes and
        dtypes, the card, and whether inference mode is on (an inference-mode graph's input
        buffers are inference tensors, which a ``no_grad`` caller cannot write). None where
        the call runs eagerly: an input off the current card or not contiguous, training
        mode, autograd or autocast on, or a tree that ``_param_ptrs`` refuses. Parameters
        moved or replaced since the last call (``.to()``, ``load_state_dict(assign=True)``,
        a parameter rebound) drop every graph first; an in-place update keeps them, and the
        next replay reads it."""
        if self.training or torch.is_grad_enabled() or torch.is_autocast_enabled():
            return None
        if not all(isinstance(a, torch.Tensor) and a.is_cuda and a.is_contiguous()
                   for a in args):
            return None
        dev = torch.cuda.current_device()
        if any(a.get_device() != dev for a in args):
            return None
        ptrs = self._param_ptrs()
        if ptrs is None:
            return None
        if ptrs != self._graph_params:
            self._drop_graphs()
            self._graph_params = ptrs
        return (tuple((a.shape, a.dtype) for a in args), dev,
                torch.is_inference_mode_enabled())

    def _param_ptrs(self):
        """The addresses of every parameter and buffer of the tree, which a captured graph
        reads; None where the forward must run eagerly: a module with forward hooks or
        pre-hooks (a global one included), or a DTensor parameter (tensor parallelism's
        plans, ``parallel/dryrun.py``)."""
        if nn_module._global_forward_hooks or nn_module._global_forward_pre_hooks:
            return None
        tensors, stack = [], [self]
        while stack:  # a plain walk: ``modules()`` costs about twice as much a call
            m = stack.pop()
            if m is None:
                continue
            if m._forward_hooks or m._forward_pre_hooks:
                return None
            tensors.extend(m._parameters.values())
            tensors.extend(m._buffers.values())
            stack.extend(m._modules.values())
        dtensor = _loaded_dtensor_type()
        if dtensor is not None and any(isinstance(t, dtensor) for t in tensors):
            return None
        return tuple(t.data_ptr() for t in tensors if t is not None)

    def _capture(self, args) -> "_Graph":
        """``_forward_eager`` captured on copies of ``args`` (the graph's input buffers),
        after warm-up calls on a side stream. Every graph of the module allocates from one
        memory pool: one forward's activations, whatever the shapes. Two graphs' buffers
        may overlap there, which is safe because a replay's output is copied out on the
        same stream before the next replay starts."""
        inputs = tuple(a.clone() for a in args)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(GRAPH_WARMUP_CALLS):
                self._forward_eager(*inputs, split=self._d_capable)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = ops.launch_counts()
        # thread_local: other threads of the process (a loader, NCCL's watchdog) may keep
        # calling CUDA while this one captures
        with torch.cuda.graph(graph, pool=self._graph_pool, capture_error_mode="thread_local"):
            output = self._forward_eager(*inputs, split=self._d_capable)
        # the capture records the wrappers' launches and runs none: each replay counts them
        launches = tuple((name, n - before[name]) for name, n in ops.launch_counts().items()
                         if n != before[name])
        for name, n in launches:
            ops.KERNEL_WRAPPERS[name].launches -= n
        return _Graph(inputs, graph, output, launches)

    def _head(self, head: nn.Sequential, x):
        """A pose head; with a compute dtype its first two layers run in it and the last in
        fp32 (it has no dtype in the JAX model), so the poses come out fp32."""
        if self.dtype is None:
            return head(x)
        x = silu(dense(silu(dense(x, head[0], self.dtype)), head[2], self.dtype), promoted=True)
        return head[4](x)


class _Graph(NamedTuple):
    """One captured inference forward: its input buffers, the graph and its output buffer."""

    inputs: tuple
    graph: object  # torch.cuda.CUDAGraph
    output: torch.Tensor
    launches: tuple  # (wrapper name, launches) that one replay runs (``ops.launch_counts``)


def _splits(layer: EncoderLayer) -> tuple:
    """An encoder layer's ``SplitWeights``."""
    return (layer.self_attn._qkv, layer.self_attn._out, layer.global_attn._qkv,
            layer.global_attn._out, layer.ff.net[0]._split, layer.ff._split)


def _loaded_dtensor_type():
    """DTensor's class where ``torch.distributed`` has loaded it, else None: no parameter
    can be a DTensor before then, and the check costs nothing."""
    for name in ("torch.distributed.tensor", "torch.distributed._tensor"):
        dtensor = getattr(sys.modules.get(name), "DTensor", None)
        if dtensor is not None:
            return dtensor
    return None


def compute_dtype(cfg) -> torch.dtype | None:
    """The denoiser's and the frozen encoder's compute dtype under ``trainer.precision``:
    bfloat16 for "bf16", else None (fp32), as the JAX package reads the key."""
    return torch.bfloat16 if cfg.trainer.precision == "bf16" else None


def make_denoiser(cfg) -> DenoiserTransformer:
    """The denoiser at a ``Config``'s widths and ``trainer.precision``. The AdaLN tables have
    the reference's 6 * embed_dim rows (3072 at width 512, the released checkpoints' size),
    and at least one per training timestep, so that small test widths still index every
    timestep."""
    d = cfg.denoiser
    return DenoiserTransformer(
        d.embed_dim, d.num_layers, d.num_heads, d.num_dim, cfg.data.max_num_part, d.multires,
        num_ada_embeds=max(6 * d.embed_dim, d.ddpm_train_steps), dropout=d.dropout,
        pe_dropout=d.pe_dropout, dtype=compute_dtype(cfg),
    )
