"""GPipe pipeline parallelism of the Qwen3 decoder over torch.distributed
(port of ``unirec_tpu/parallel/pipeline.py``).

The ranks are laid out ``(dp, pp)``, pp the fastest axis
(``parallel/mesh.pipe_mesh``, JAX's ``make_pp_mesh``).  Each stage holds
``num_hidden_layers / pp`` consecutive decoder layers and only those; the
embeddings, the final norm and the joint model's Q-Former are replicated
over pp, as the JAX package replicates them.

* ``split_layer_params`` stacks the ``layers.{i}.`` tensors of a Qwen3
  state_dict on a leading layer axis (the axis pp splits) and
  ``merge_layer_params`` undoes it bit for bit; ``split_joint_params`` /
  ``merge_joint_params`` do the same for the joint model's
  ``base_model.`` and ``qformer.`` parts, and ``stage_state_dict`` takes one
  stage's layers from the stacked tree.
* ``PipelinedQwen3`` runs the GPipe schedule: each rank's batch rows split
  into M microbatches, which go forward through the stages with
  point-to-point sends of ``[mb, L, D]`` activations, then backward in
  reverse (``backward``).  The bubble is ``(S-1)/(M+S-1)``.  JAX's program
  is one differentiable scan whose backward falls out of ``jax.vjp``; here
  each stage keeps its microbatches' inputs and outputs and the backward
  sends the input gradients back explicitly.  ``remat=True`` checkpoints
  each layer application.  The last stage's hidden states are broadcast
  to every stage (JAX's ``psum`` over pp), where the final norm applies.
* ``joint_pp_forward``: the joint model with the pipelined decoder.  Stage 0
  runs the Q-Former and the token injection and feeds the pipeline (JAX
  runs them on every stage and uses stage 0's; the other stages' would be
  discarded, so they do not run them here); pooling and the loss follow
  on every stage.  In a training forward only the last stage's loss
  starts a backward.

Gradients of the replicated leaves are nonzero on the stage that uses them
(stage 0: the Q-Former and the extra token embeddings) and zero elsewhere,
so summing them over pp gives every stage the gradient
(``train/joint.make_pipeline_train_step``); a stage's layers keep their
own.  Dropout keys keep JAX's fold-in structure, on the port's streams
(``ops/dropout.py``): the step, then the dp index, the global layer and
the microbatch for each layer application, and ``1 << 20`` (then the dp
index) for the Q-Former.

Point-to-point traffic: NCCL sends the device tensors; a gloo group (the
CPU, or two ranks that share one card, which NCCL refuses) sends CUDA
tensors through host memory, since gloo's send and recv take CPU tensors.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from unirec_tpu_torch.configs import (
    ItemQFormerConfig,
    JointModelConfig,
    LoRAConfig,
    Qwen3Config,
)
from unirec_tpu_torch.models.item_qformer import ItemQFormer
from unirec_tpu_torch.models.joint import inject_query_tokens, pool
from unirec_tpu_torch.models.qwen3 import (
    Qwen3Layer,
    Qwen3Model,
    RMSNorm,
    rotary_embedding,
)
from unirec_tpu_torch.ops.dropout import DropoutStream
from unirec_tpu_torch.ops.flash_causal import check_pad_mask
from unirec_tpu_torch.parallel.mesh import PipeMesh, pipe_mesh, visible_devices

DP_AXIS, PP_AXIS = "dp", "pp"
LAYER_PREFIX = "layers."
BASE_PREFIX, QFORMER_PREFIX = "base_model.", "qformer."
# the Q-Former's dropout stream, apart from the layers' (layer, microbatch)
QFORMER_STREAM = 1 << 20


def make_pp_mesh(pp: int, dp: Optional[int] = None,
                 devices: Optional[Sequence[Any]] = None) -> np.ndarray:
    """A ``(dp, pp)`` layout of devices (default: the visible cards), batch
    over dp, stages over pp; ``dp`` None takes every device."""
    devices = list(devices if devices is not None else visible_devices())
    if dp is None:
        dp = len(devices) // pp
    need = dp * pp
    if need > len(devices):
        raise ValueError(f"mesh {dp}x{pp} needs {need} devices, "
                         f"have {len(devices)}")
    grid = np.empty(need, dtype=object)
    grid[:] = devices[:need]
    return grid.reshape(dp, pp)


def split_layer_params(params: Mapping[str, torch.Tensor]
                       ) -> Tuple[Dict[str, torch.Tensor],
                                  Dict[str, torch.Tensor]]:
    """Qwen3Model state_dict -> (stacked, rest): ``stacked`` maps each
    in-layer name (``self_attn.q_proj.weight``) to the layers' tensors
    stacked on a new leading axis ``[num_layers, ...]``; ``rest`` is
    everything else (embeddings, final norm) as it is."""
    layers: Dict[str, Dict[int, torch.Tensor]] = {}
    rest = {}
    for name, t in params.items():
        if name.startswith(LAYER_PREFIX):
            index, _, leaf = name[len(LAYER_PREFIX):].partition(".")
            layers.setdefault(leaf, {})[int(index)] = t
        else:
            rest[name] = t
    if not layers:
        raise ValueError("no layers.* entries in params")
    n = 1 + max(i for per in layers.values() for i in per)
    stacked = {}
    for leaf, per in layers.items():
        if sorted(per) != list(range(n)):
            raise ValueError(f"layers of {leaf!r}: {sorted(per)}, expected "
                             f"0..{n - 1}")
        stacked[leaf] = torch.stack([per[i] for i in range(n)])
    return stacked, rest


def merge_layer_params(stacked: Mapping[str, torch.Tensor],
                       rest: Mapping[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """Inverse of ``split_layer_params`` (checkpoint interchange)."""
    out = dict(rest)
    n = next(iter(stacked.values())).shape[0]
    for i in range(n):
        for leaf, t in stacked.items():
            out[f"{LAYER_PREFIX}{i}.{leaf}"] = t[i].clone()
    return out


def _strip(params: Mapping[str, torch.Tensor], prefix: str) -> Dict:
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


def split_joint_params(params: Mapping[str, torch.Tensor]):
    """MultiModalQwenEmbedding state_dict -> (stacked decoder layers,
    decoder rest, Q-Former state_dict)."""
    stacked, rest = split_layer_params(_strip(params, BASE_PREFIX))
    return stacked, rest, _strip(params, QFORMER_PREFIX)


def merge_joint_params(stacked: Mapping[str, torch.Tensor],
                       rest: Mapping[str, torch.Tensor],
                       qformer: Mapping[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """Inverse of ``split_joint_params``."""
    out = {BASE_PREFIX + k: v
           for k, v in merge_layer_params(stacked, rest).items()}
    out.update({QFORMER_PREFIX + k: v for k, v in qformer.items()})
    return out


def stage_state_dict(stacked: Mapping[str, torch.Tensor],
                     rest: Mapping[str, torch.Tensor],
                     qformer: Mapping[str, torch.Tensor], stage: int,
                     num_stages: int) -> Dict[str, torch.Tensor]:
    """The ``JointPipelineStage`` state_dict of ``stage``: its layers (new
    tensors, numbered from 0), the decoder's rest and the Q-Former."""
    n = next(iter(stacked.values())).shape[0]
    per = n // num_stages
    out = {BASE_PREFIX + k: v for k, v in rest.items()}
    for j in range(per):
        for leaf, t in stacked.items():
            out[f"{BASE_PREFIX}{LAYER_PREFIX}{j}.{leaf}"] = (
                t[stage * per + j].clone())
    out.update({QFORMER_PREFIX + k: v for k, v in qformer.items()})
    return out


def check_pipeline(config: Qwen3Config, num_stages: int) -> None:
    """The JAX ``PipelinedQwen3``'s refusals."""
    if config.num_hidden_layers % num_stages:
        raise ValueError(f"num_hidden_layers={config.num_hidden_layers} not "
                         f"divisible by pp={num_stages}")
    if config.flash_vjp_attention:
        raise ValueError(
            "flash_vjp_attention is not supported under pipeline "
            "parallelism: the pp schedule drives layers with additive "
            "biases, not pad masks. Unset Qwen3Config.flash_vjp_attention"
            " or train on a dp-only mesh (train joint --flash-vjp).")


class PipelinedQwen3(nn.Module):
    """One stage of the Qwen3 decoder under ``pipe``: its
    ``num_hidden_layers / pp`` consecutive layers (``layers.{j}`` is global
    layer ``first_layer + j``) and the replicated embeddings and final norm
    (the JAX ``rest``).

    ``forward`` takes stage 0's ``inputs_embeds`` (None elsewhere) and every
    stage's ``attention_mask`` (this rank's rows), and returns the final-norm
    hidden states ``[B, L, D]`` on every stage.  A training forward (train
    mode, gradients on) keeps what ``backward(loss)`` needs.  The
    deterministic forward's attention is K1 on the card; the training
    forward's the plain additive-mask path (flash-VJP is refused, as in the
    JAX package)."""

    embed = Qwen3Model.embed

    def __init__(self, config: Qwen3Config, pipe: Optional[PipeMesh] = None,
                 num_microbatches: int = 1, lora: Optional[LoRAConfig] = None,
                 n_extra_tokens: int = 0, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None,
                 remat: bool = True):
        super().__init__()
        self.pipe = pipe = pipe if pipe is not None else pipe_mesh(1)
        check_pipeline(config, pipe.num_stages)
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        pkw = dict(device=device, dtype=param_dtype or dtype)
        self.config, self.dtype, self.remat = config, dtype, remat
        self.num_microbatches = num_microbatches
        self.layers_per_stage = config.num_hidden_layers // pipe.num_stages
        self.first_layer = pipe.stage * self.layers_per_stage
        self.embed_tokens = nn.Parameter(
            torch.empty(config.vocab_size, config.hidden_size, **pkw))
        self.extra_embed_tokens = (
            nn.Parameter(torch.empty(n_extra_tokens, config.hidden_size,
                                     **pkw))
            if n_extra_tokens > 0 else None)
        self.layers = nn.ModuleList(Qwen3Layer(config, lora, **kw)
                                    for _ in range(self.layers_per_stage))
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, **kw)
        self._saved = None

    # -- point to point ---------------------------------------------------

    def _staged(self, t: torch.Tensor) -> bool:
        return (t.is_cuda
                and dist.get_backend(self.pipe.pp_group) == "gloo")

    def _send(self, t: torch.Tensor, dst: int) -> None:
        t = t.detach().contiguous()
        dist.send(t.cpu() if self._staged(t) else t, dst=dst,
                  group=self.pipe.pp_group)

    def _recv(self, like: torch.Tensor, src: int) -> torch.Tensor:
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if self._staged(like) else like.device)
        dist.recv(buf, src=src, group=self.pipe.pp_group)
        return buf.to(like.device)

    # -- the schedule -----------------------------------------------------

    def _stage(self, h, cos, sin, pad, dropout, mb: int, train: bool):
        for j, layer in enumerate(self.layers):
            drop = None
            if dropout is not None:
                drop = dropout.at(DP_AXIS, self.pipe.dp_index, "layers",
                                  self.first_layer + j, "microbatch", mb)
            if train and self.remat:
                h = checkpoint(layer, h, cos, sin, pad, drop,
                               use_reentrant=False)
            else:
                h = layer(h, cos, sin, pad, drop)
        return h

    def forward(self, inputs_embeds: Optional[torch.Tensor],
                attention_mask: torch.Tensor,
                dropout: Optional[DropoutStream] = None) -> torch.Tensor:
        """``dropout``: a training forward's step stream (None: none)."""
        cfg, pipe = self.config, self.pipe
        stages, m_count = pipe.num_stages, self.num_microbatches
        first, last = pipe.stage == 0, pipe.stage == stages - 1
        b, l = attention_mask.shape
        if b % m_count:
            raise ValueError(f"batch of {b} rows must be a multiple of "
                             f"num_microbatches={m_count}")
        mb = b // m_count
        device = attention_mask.device
        pad = attention_mask.float()
        check_pad_mask(pad)  # once per forward, for every layer
        positions = torch.arange(l, device=device)[None].expand(mb, l)
        cos, sin = rotary_embedding(positions, cfg.head_dim, cfg.rope_theta,
                                    dtype=self.dtype)
        train = self.training and torch.is_grad_enabled()
        like = torch.empty((mb, l, cfg.hidden_size), dtype=self.dtype,
                           device=device)
        x = x_leaf = None
        if first:
            if inputs_embeds is None:
                raise ValueError("stage 0 needs inputs_embeds")
            x = x_leaf = inputs_embeds.to(self.dtype)
            if train:  # the microbatches' backwards meet here
                x_leaf = x.detach().requires_grad_()
            chunks = x_leaf.split(mb)
        ins: List[torch.Tensor] = []
        outs: List[torch.Tensor] = []
        for m in range(m_count):
            if first:
                h = chunks[m]
            else:
                h = self._recv(like, pipe.prev_rank)
                if train:
                    h.requires_grad_()
            out = self._stage(h, cos, sin, pad[m * mb:(m + 1) * mb], dropout,
                              m, train)
            if not last:
                self._send(out, pipe.next_rank)
            ins.append(h)
            outs.append(out)
        y = torch.cat(outs) if last else torch.empty(
            (b, l, cfg.hidden_size), dtype=self.dtype, device=device)
        if stages > 1:  # the last stage's states reach every stage
            buf = y.detach().contiguous() if last else y
            dist.broadcast(buf, src=pipe.last_rank, group=pipe.pp_group)
            if not last:
                y = buf
        self._saved = (x, x_leaf, ins, outs) if train else None
        return self.norm(y)

    def backward(self, loss: torch.Tensor) -> None:
        """The backward of the last training forward: the last stage takes
        ``loss``'s gradient of its microbatches' outputs (the other stages
        ignore ``loss``), each stage backpropagates its microbatches in
        reverse and sends the input gradients to the previous stage, and
        stage 0 carries them into whatever produced ``inputs_embeds``."""
        if self._saved is None:
            raise RuntimeError("backward needs a training forward first")
        x, x_leaf, ins, outs = self._saved
        self._saved = None
        pipe = self.pipe
        first, last = pipe.stage == 0, pipe.stage == pipe.num_stages - 1
        grads = torch.autograd.grad(loss, outs) if last else None
        for m in reversed(range(len(outs))):
            g = grads[m] if last else self._recv(outs[m], pipe.next_rank)
            torch.autograd.backward(outs[m], g)
            if not first:
                self._send(ins[m].grad, pipe.prev_rank)
        if first and x.requires_grad:
            torch.autograd.backward(x, x_leaf.grad)


class JointPipelineStage(nn.Module):
    """One pipeline stage of ``models/joint.MultiModalQwenEmbedding``: the
    stage's decoder (``base_model``, a ``PipelinedQwen3``) and the replicated
    Q-Former, with the joint model's parameter names (a stage's layers
    numbered from 0)."""

    def __init__(self, qwen_config: Qwen3Config,
                 qformer_config: ItemQFormerConfig,
                 joint_config: JointModelConfig = JointModelConfig(),
                 lora: Optional[LoRAConfig] = None,
                 pipe: Optional[PipeMesh] = None, num_microbatches: int = 1,
                 *, device=None, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None,
                 remat: bool = True):
        super().__init__()
        if qformer_config.hidden_size != qwen_config.hidden_size:
            raise ValueError(
                "query-token injection requires Q-Former hidden_size "
                f"({qformer_config.hidden_size}) == LLM hidden_size "
                f"({qwen_config.hidden_size})")
        self.qwen_config, self.joint_config = qwen_config, joint_config
        jc = joint_config
        self.base_model = PipelinedQwen3(
            qwen_config, pipe, num_microbatches, lora,
            jc.num_history_items * jc.num_query_tokens_per_item,
            device=device, dtype=dtype, param_dtype=param_dtype, remat=remat)
        self.qformer = ItemQFormer(qformer_config, device=device, dtype=dtype,
                                   param_dtype=param_dtype)

    def forward(self, *args, **kw) -> torch.Tensor:
        return joint_pp_forward(self, *args, **kw)


def joint_pp_forward(stage: JointPipelineStage, input_ids: torch.Tensor,
                     attention_mask: Optional[torch.Tensor] = None,
                     history_field_embeddings: Optional[torch.Tensor] = None,
                     history_attention_mask: Optional[torch.Tensor] = None,
                     dropout: Optional[DropoutStream] = None) -> torch.Tensor:
    """The joint forward with the decoder pipelined, on this rank's rows:
    pooled ``[B, D]`` on every stage.  ``dropout``: a training forward's
    step stream."""
    base = stage.base_model
    if attention_mask is None:
        attention_mask = torch.ones(input_ids.shape, device=input_ids.device)
    text = None
    if base.pipe.stage == 0:
        qf_drop = None
        if dropout is not None:
            qf_drop = dropout.at(QFORMER_STREAM, DP_AXIS, base.pipe.dp_index)
        text = inject_query_tokens(
            stage.qformer, stage.joint_config, stage.qwen_config.vocab_size,
            base.embed(input_ids), input_ids, history_field_embeddings,
            history_attention_mask, qf_drop)
    hidden = base(text, attention_mask, dropout)
    return pool(hidden, attention_mask, stage.joint_config.pool)


def merged_state_dict(stage: JointPipelineStage) -> Dict[str, torch.Tensor]:
    """The joint model's full state_dict from every stage's layers (a
    collective over the pp group: every stage calls it) and this stage's
    replicated tensors.  Tensors travel as one flat buffer per dtype, half
    precision as int16 (gloo's types), bit for bit."""
    base = stage.base_model
    pipe, per = base.pipe, base.layers_per_stage
    prefix = BASE_PREFIX + LAYER_PREFIX
    local = {n: t.detach() for n, t in stage.state_dict().items()}
    names = [n for n in local if n.startswith(prefix)]
    out = {n: t for n, t in local.items() if not n.startswith(prefix)}
    by_dtype: Dict[torch.dtype, List[str]] = {}
    for n in names:
        by_dtype.setdefault(local[n].dtype, []).append(n)
    for dtype, group_names in by_dtype.items():
        flat = torch.cat([local[n].reshape(-1) for n in group_names])
        wire = (flat.view(torch.int16)
                if dtype in (torch.bfloat16, torch.float16) else flat)
        parts = [wire]
        if pipe.num_stages > 1:
            parts = [torch.empty_like(wire) for _ in range(pipe.num_stages)]
            dist.all_gather(parts, wire, group=pipe.pp_group)
        sizes = [local[n].numel() for n in group_names]
        for s, part in enumerate(parts):
            for n, piece in zip(group_names, part.view(dtype).split(sizes)):
                j, _, leaf = n[len(prefix):].partition(".")
                out[f"{prefix}{s * per + int(j)}.{leaf}"] = piece.view(
                    local[n].shape)
    return out
