"""Attention primitives for the Q-Former stacks (port of
``unirec_tpu/ops/attention.py``): the fp32-softmax path with its
attention-probability dropout, the streaming cross-attention B13 and the
dispatch between them.

Layout and semantics follow the JAX module: per-head ``[B, H, L, head_dim]``
tensors and an additive bias broadcastable to ``[B, H, Lq, Lkv]`` with
``NEG_INF`` at masked keys.

``flash_cross_attention`` is kernel B13 (``csrc/flash_cross.cu``, replacing
``flash_cross_attention``'s ``_flash_kernel``): streaming softmax over the
memory axis, so the ``[B, H, Lq, Lkv]`` scores never reach device memory.  It
takes a per-key bias ``[B, 1, 1, Lkv]`` (the only mask the Q-Former's cross
attention uses) and has no gradient.  ``cross_attention`` is the JAX
dispatch: B13 for deterministic forwards over a memory of at least
``FLASH_MIN_KV`` rows on the card (the user Q-Former's history, 1,600 rows at
seq 50), the plain path otherwise (the item Q-Former's 14 fields, training
forwards).  ``use_flash_cross`` is that decision as a pure predicate.
"""

from __future__ import annotations

import collections
import functools
import math
from typing import Optional, Tuple

import torch

from unirec_tpu_torch.ops._build import check, load_kernels
from unirec_tpu_torch.ops.dropout import DropoutStream, dropout

# exp(-1e9) == 0.0 in fp32: identical to the reference's additive -10000.
NEG_INF = -1e9

# Memory length from which the JAX package takes its streaming kernel.
FLASH_MIN_KV = 1024

# the head dimensions the streaming kernels (csrc/flash_cross.cu) and the
# causal flash kernels K1 and B7b (csrc/flash_causal_*.cu) are built for
# (csrc/head_dim.cuh): every multiple of 16 up to 128, and 256.  Any other
# head dim up to the largest instance runs zero-padded to the next one
# (``padded_launch``); above it, the head dim is cut into chunks of the
# largest instance (``kernel_head_dim``), which the kernels' chunked form
# (csrc/flash_chunked.cuh) runs over a grid axis.  The packed item attention
# takes every head dim as it is (csrc/packed_attention.cu).
KERNEL_HEAD_DIMS = tuple(range(16, 129, 16)) + (256,)
# the chunked form's launches by kind (``unirec_chunked_form``): the forward
# (K1, B13, B14, B14p), the backward over rows (B7b's dq, B14 / B14p's one
# pass) and the backward over keys (B7b's dk / dv)
CHUNKED_FWD, CHUNKED_ROWS, CHUNKED_KEYS = 0, 1, 2
_FORMS = {1: "scalar", 2: "tensor_cores", 3: "cluster", 4: "cluster_tf32"}
# the chunked forward's tiles (bf16 and the float32 cluster form): 64 query
# rows, 32 keys; the float32 cluster form's backward over rows takes 16 keys
# (the key tiles that ``chunked_plan`` splits)
CHUNK_Q_TILE, CHUNK_KEY_TILE, CHUNK_ROWS_KEY_TILE = 64, 32, 16


def make_additive_mask(mask: torch.Tensor,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, Lk] 0/1 validity mask -> additive bias [B, 1, 1, Lk]."""
    return ((1.0 - mask.to(dtype)) * NEG_INF)[:, None, None, :]


def make_causal_mask(attention_mask: torch.Tensor, seq_length: int,
                     query_length: int = 0,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The decoder's additive mask ``[B, 1, L, L]`` over ``query_length``
    query tokens then ``seq_length`` text tokens (the JAX
    ``make_causal_mask``, BERT's ``get_extended_attention_mask``): text rows
    see the whole prefix and the text up to themselves, prefix rows (UniLM)
    only the prefix; times the ``[B, L]`` padding mask."""
    total = query_length + seq_length
    i = torch.arange(total, device=attention_mask.device)[:, None]
    j = torch.arange(total, device=attention_mask.device)[None, :]
    causal = (j <= i) | (j < query_length)
    allowed = torch.where(i < query_length, j < query_length, causal)
    combined = allowed[None].to(dtype) * attention_mask[:, None, :].to(dtype)
    return ((1.0 - combined) * NEG_INF)[:, None, :, :]


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, L, D] -> [B, H, L, D // H]."""
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, hd] -> [B, L, H * hd]."""
    b, h, l, hd = x.shape
    return x.transpose(1, 2).reshape(b, l, h * hd)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
              drop: Optional[DropoutStream] = None,
              return_probs: bool = False):
    """Softmax attention with fp32 scores and softmax whatever the input
    dtype; probabilities are cast back to the input dtype before the value
    product, which accumulates in fp32 (the JAX einsums'
    ``preferred_element_type=float32``).  A training forward's ``drop``
    stream applies attention-probability dropout to the fp32 probabilities,
    as the JAX function does.  ``return_probs`` (introspection) returns
    ``(out, probs)``, the post-dropout fp32 ``[B, H, Lq, Lkv]``."""
    in_dtype = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.float()
    probs = dropout(torch.softmax(scores, dim=-1), dropout_rate, drop)
    out = torch.matmul(probs.to(in_dtype).float(), v.float()).to(in_dtype)
    return (out, probs) if return_probs else out


# -- B13: streaming cross-attention -------------------------------------------


def sm_scale(head_dim: int) -> float:
    """1 / sqrt(head_dim) as the float32 the JAX kernels multiply by."""
    return float(torch.tensor(1.0 / head_dim ** 0.5, dtype=torch.float32))


def streaming_softmax_stats(s: torch.Tensor) -> Tuple[torch.Tensor,
                                                      torch.Tensor,
                                                      torch.Tensor]:
    """(p, m, l) of fp32 scores ``s [..., Lkv]``, as the streaming kernels end
    up with them: m = max(NEG_INF, max s) (their running max starts at
    NEG_INF), p = exp(s - m) and l = sum p, with keepdim."""
    m = torch.clamp_min(s.amax(dim=-1, keepdim=True), NEG_INF)
    p = torch.exp(s - m)
    return p, m, p.sum(dim=-1, keepdim=True)


def key_bias(bias: Optional[torch.Tensor], b: int, lkv: int,
             device) -> Optional[torch.Tensor]:
    """A per-key bias ``[B, 1, 1, Lkv]`` (or None) as the kernels read it:
    float32 ``[B, Lkv]``, contiguous."""
    if bias is None:
        return None
    if bias.dim() != 4 or bias.shape[1] != 1 or bias.shape[2] != 1:
        raise ValueError(f"the streaming kernels take a per-key bias "
                         f"[B, 1, 1, Lkv], got {tuple(bias.shape)}")
    return bias.to(device=device, dtype=torch.float32).expand(
        b, 1, 1, lkv).reshape(b, lkv).contiguous()


def flash_cross_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor,
                                bias: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """B13's plain version: ``_flash_kernel``'s function in one pass.
    s = (q . k) * scale + bias in fp32, m and l as the streaming loop leaves
    them, o = (exp(s - m) v) / (l == 0 ? 1 : l) cast to q's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s * sm_scale(q.shape[-1])
    if bias is not None:
        s = s + bias.float()
    p, _, l = streaming_softmax_stats(s)
    o = torch.matmul(p, v.float()) / torch.where(l == 0, 1.0, l)
    return o.to(q.dtype)


def dtype_code(t: torch.Tensor) -> int:
    """The streaming kernels' dtype argument: 0 float32, 1 bfloat16."""
    return 0 if t.dtype == torch.float32 else 1


def kernel_head_dim(name: str, head_dim: int) -> Tuple[int, int]:
    """(instance, chunks): the kernels run ``head_dim`` at ``instance *
    chunks`` columns.  Up to the largest instance of ``KERNEL_HEAD_DIMS``,
    one chunk at the least instance not below it; above it, C = ceil(hd /
    256) chunks of 256 (``csrc/flash_chunked.cuh``).  Raises, naming the
    set, for a head dim below 1."""
    if head_dim <= 0:
        raise ValueError(f"{name} is built for head_dim in {KERNEL_HEAD_DIMS} "
                         f"(chunks of {KERNEL_HEAD_DIMS[-1]} above) and pads "
                         f"any other, got {head_dim}")
    for hd in KERNEL_HEAD_DIMS:
        if head_dim <= hd:
            return hd, 1
    widest = KERNEL_HEAD_DIMS[-1]
    return widest, -(-head_dim // widest)


def check_head_dim(name: str, head_dim: int) -> None:
    """Raise unless the kernels take ``head_dim``: every head dim of at
    least 1, the instances as they are, any other zero-padded to the next
    one or, above the largest, to whole chunks of it (``padded_launch``)."""
    kernel_head_dim(name, head_dim)


def _pad_heads(t: torch.Tensor, heads: Optional[int], hd: int) -> torch.Tensor:
    """t with each head's columns zero-padded to ``hd``: the last dim is
    the head dim (``heads`` None) or ``heads`` merged head dims."""
    if heads is None:
        return torch.nn.functional.pad(t, (0, hd - t.shape[-1]))
    *lead, d = t.shape
    split = t.reshape(*lead, heads, d // heads)
    return torch.nn.functional.pad(split, (0, hd - d // heads)).reshape(
        *lead, heads * hd)


def padded_launch(name: str, head_dim: int, inputs, outputs,
                  launch) -> None:
    """Run ``launch(ins, outs, kernel_hd)``, kernel_hd the head dim that
    the C entries take: the tensors' own width at an instance, and above 256
    where a row of a head is whole 16-byte pieces (the chunked form zero-fills
    the last chunk's missing columns as it loads them and stores only the
    true ones); otherwise instance * chunks (``kernel_head_dim``).
    ``inputs`` and ``outputs`` are (tensor, heads) pairs: heads None for a
    tensor whose last dim is the head dim, H for merged heads ``[..., H *
    head_dim]``.  Where kernel_hd is not head_dim the inputs go zero-padded
    to it and the outputs into padded scratch, whose true columns are copied
    back after the launch.  Zero lanes add exact zeros to every dot product,
    so the scores, m, l, o and the gradients' true columns are unchanged; the
    caller passes the softmax scale of the true head dim (``sm_scale``).
    Every head dim runs in both dtypes: above 256 the kernels pick their form
    by the chunk count (``chunked_form``)."""
    instance, chunks = kernel_head_dim(name, head_dim)
    hd = instance * chunks
    piece = 16 // inputs[0][0].element_size()  # elements of a 16-byte load
    if hd == head_dim or (chunks > 1 and head_dim % piece == 0):
        launch([t for t, _ in inputs], [t for t, _ in outputs], head_dim)
        return
    ins = [_pad_heads(t, heads, hd) for t, heads in inputs]
    outs = [torch.empty(*t.shape[:-1], hd * (heads or 1), device=t.device,
                        dtype=t.dtype) for t, heads in outputs]
    launch(ins, outs, hd)
    for (t, heads), padded in zip(outputs, outs):
        if heads is None:
            t.copy_(padded[..., :head_dim])
        else:  # one copy, view to view
            t.unflatten(-1, (heads, head_dim)).copy_(
                padded.unflatten(-1, (heads, hd))[..., :head_dim])


def check_kernel_tensors(name: str, *tensors: torch.Tensor) -> None:
    """What the streaming kernels take: one CUDA device, float32 or
    bfloat16 of one dtype, the head dimension contiguous and every row on a
    16-byte boundary (they read rows with 16-byte loads): the data pointer
    and each stride of a dimension longer than 1 in multiples of 16
    bytes."""
    first = tensors[0]
    if first.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {first.device}")
    if first.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes float32 or bfloat16, got {first.dtype}")
    for t in tensors:
        if t.dtype != first.dtype or t.device != first.device:
            raise TypeError(f"{name}: all tensors must share {first.dtype} on "
                            f"{first.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dimension must be contiguous")
        size = t.element_size()
        if t.data_ptr() % 16 or any(
                n > 1 and st * size % 16
                for n, st in zip(t.shape[:-1], t.stride()[:-1])):
            raise ValueError(f"{name}: rows must start on 16-byte boundaries "
                             f"(strides {t.stride()})")


def chunked_form(kind: int, kernel_hd: int, t: torch.Tensor) -> Optional[str]:
    """The form that a chunked launch of ``kind`` (``CHUNKED_FWD``,
    ``CHUNKED_ROWS``, ``CHUNKED_KEYS``) takes at the kernels' head dim in t's
    dtype, as ``csrc/flash_chunked.cuh`` chooses it by shape before any
    launch: bf16 "tensor_cores" where its shared memory holds the C chunks
    (the forward C <= 5, the backward over rows C <= 2, over keys C <= 4),
    "cluster" above those up to 8 chunks in the forward and over rows (one
    block a chunk in a thread-block cluster); float32 "cluster_tf32" up to 8
    chunks in the forward and over rows (the cluster schedule, products in
    3xTF32); "scalar" otherwise (above 8 chunks, and over keys: bf16 above
    4 chunks, float32 always); None at a head dim that is not chunked."""
    return _chunked_form(kind, kernel_hd, dtype_code(t))


def count_form(wrapper, kind: int, kernel_hd: int, t: torch.Tensor) -> None:
    """One more launch in ``wrapper.forms`` (a Counter) of the form the
    kernels chose (``chunked_form``); none at a head dim that is not
    chunked."""
    form = chunked_form(kind, kernel_hd, t)
    if form is not None:
        wrapper.forms[form] += 1


@functools.lru_cache(maxsize=None)
def _chunked_form(kind: int, kernel_hd: int, dtype: int) -> Optional[str]:
    code = load_kernels().lib.unirec_chunked_form(kind, kernel_hd, dtype)
    if code < 0:
        raise ValueError(f"no chunked kind {kind} for dtype code {dtype}")
    return _FORMS.get(code)


def chunked_fwd_splits(blocks: int, key_tiles: int, sms: int,
                       per_sm: int = 2) -> int:
    """Key splits of a chunked launch that takes them (``chunked_plan``): a
    grid of ``blocks`` (q tiles x heads x chunks x batch) that holds fewer
    than ``per_sm`` blocks per SM splits each row's ``key_tiles`` over as
    many blocks as fill ``per_sm`` per SM, each split at least 4 key tiles
    long."""
    return max(1, min(per_sm * sms // max(blocks, 1), key_tiles // 4))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def scratch_width(kernel_hd: int) -> int:
    """Columns of a row of the kernels' float32 scratch at ``kernel_hd``:
    above 256, whole chunks of 256 (``csrc/flash_chunked.cuh``)."""
    widest = KERNEL_HEAD_DIMS[-1]
    return kernel_hd if kernel_hd <= widest else -(-kernel_hd // widest) * widest


# The chunked launches that split each row's keys over blocks when their
# grid holds too few blocks for the card, by (kind, causal, form): (key
# tile, blocks an SM that the splits fill).  bf16's cross forward on tensor
# cores and in clusters fills two blocks an SM (K1 takes no split: its merge
# cost more than the split saved at B 2, L 512); the float32 cluster form
# ("cluster_tf32"), whose shared memory holds one block an SM, fills one
# with the cross kernels and two with K1 and B7b's dq (a causal grid's last
# q tiles visit n_qt times the key tiles of its first), its backward over
# rows on 16-key tiles.  A second launch merges the splits' (o, m, l) in
# split order (forward) or adds their dq (over rows).
_KEY_SPLITS = {
    (CHUNKED_FWD, False, "tensor_cores"): (CHUNK_KEY_TILE, 2),
    (CHUNKED_FWD, False, "cluster"): (CHUNK_KEY_TILE, 2),
    (CHUNKED_FWD, False, "cluster_tf32"): (CHUNK_KEY_TILE, 1),
    (CHUNKED_ROWS, False, "cluster_tf32"): (CHUNK_ROWS_KEY_TILE, 1),
    (CHUNKED_FWD, True, "cluster_tf32"): (CHUNK_KEY_TILE, 2),
    (CHUNKED_ROWS, True, "cluster_tf32"): (CHUNK_ROWS_KEY_TILE, 2),
}


def chunked_plan(q: torch.Tensor, kind: int, b: int, h: int, lq: int,
                 lkv: int, kernel_hd: int, form: Optional[str],
                 causal: bool = False):
    """(splits, scratch) of one chunked launch of ``kind`` (``CHUNKED_FWD``
    or ``CHUNKED_ROWS``; ``causal`` for K1 and B7b's dq) over ``lq`` query
    rows and ``lkv`` keys in ``h`` heads at the kernels' head dim, whose
    form is ``form`` (``chunked_form``): the splits of ``_KEY_SPLITS``
    (``chunked_fwd_splits``), whose float32 partials go to ``splits * b * h
    * lq * width`` floats of scratch, width C * 256 + 2 for the forward's
    (o, m, l) and C * 256 for dq; (1, None) for every other launch and for a
    grid that fills the card."""
    rule = _KEY_SPLITS.get((kind, causal, form))
    if rule is None:
        return 1, None
    key_tile, per_sm = rule
    chunks = -(-kernel_hd // KERNEL_HEAD_DIMS[-1])
    blocks = -(-lq // CHUNK_Q_TILE) * h * chunks * b
    splits = chunked_fwd_splits(blocks, -(-lkv // key_tile),
                                _sm_count(q.device.index or 0), per_sm)
    if splits == 1:
        return 1, None
    width = scratch_width(kernel_hd) + (2 if kind == CHUNKED_FWD else 0)
    return splits, torch.empty(splits * b * h * lq * width, device=q.device,
                               dtype=torch.float32)


def launch_flash_cross_fwd(q, k, v, bias32, o, m=None, l=None) -> None:
    """The forward kernel of ``csrc/flash_cross.cu`` on per-head views
    ``[B, H, L, hd]`` of any (batch, head, row) strides: B13 without (m, l),
    the forward of B14 and B14p with them (float32 ``[B, Lq, H]``).  o is in
    q's dtype for B13 and float32 for B14 and B14p.  A head dim that is not
    an instance runs zero-padded (``padded_launch``); the chunked form's
    launches count by form in ``launch_flash_cross_fwd.forms``."""
    b, h, lq, hd = q.shape

    def launch(ins, outs, kernel_hd):
        qk, kk, vk = ins
        strides = [s for t in (*ins, *outs) for s in t.stride()[:3]]
        form = chunked_form(CHUNKED_FWD, kernel_hd, q)
        splits, part = chunked_plan(q, CHUNKED_FWD, b, h, lq, k.shape[2],
                                    kernel_hd, form)
        err = load_kernels().lib.unirec_flash_cross_fwd(
            qk.data_ptr(), kk.data_ptr(), vk.data_ptr(),
            None if bias32 is None else bias32.data_ptr(), outs[0].data_ptr(),
            None if m is None else m.data_ptr(),
            None if l is None else l.data_ptr(),
            None if part is None else part.data_ptr(), *strides, b, h, lq,
            k.shape[2], kernel_hd, dtype_code(q), splits, sm_scale(hd),
            torch.cuda.current_stream(q.device).cuda_stream)
        check(err, "flash_cross_fwd")
        count_form(launch_flash_cross_fwd, CHUNKED_FWD, kernel_hd, q)

    padded_launch("the streaming forward", hd,
                  [(q, None), (k, None), (v, None)], [(o, None)], launch)


launch_flash_cross_fwd.forms = collections.Counter()


def flash_cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Streaming-softmax cross attention (B13).  q ``[B, H, Lq, hd]``, k / v
    ``[B, H, Lkv, hd]`` (views with a contiguous head dim, such as
    ``split_heads`` of a projection), bias ``[B, 1, 1, Lkv]`` or None.
    Returns ``[B, H, Lq, hd]`` in q's dtype, laid out so that
    ``merge_heads`` copies nothing.  CPU tensors take the plain version; on
    the card it launches the kernel or raises, also when an input needs a
    gradient (the kernel has none)."""
    b, h, lq, hd = q.shape
    lkv = k.shape[2]
    if k.shape != (b, h, lkv, hd) or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if q.device.type == "cpu":
        return flash_cross_attention_plain(q, k, v, bias)
    check_kernel_tensors("B13", q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_cross_attention has no gradient: a training forward goes "
            "through ops/flash_vjp.flash_cross_attention_proj_vjp")
    out = torch.empty(b, lq, h, hd, device=q.device,
                      dtype=q.dtype).transpose(1, 2)
    launch_flash_cross_fwd(q, k, v, key_bias(bias, b, lkv, q.device), out)
    flash_cross_attention.launches += 1
    return out


flash_cross_attention.launches = 0


def use_flash_cross(on_card: bool, deterministic: bool, lkv: int) -> bool:
    """The JAX dispatch's answer: the streaming kernel serves deterministic
    forwards (it has no gradient and no dropout) over a memory of at least
    ``FLASH_MIN_KV`` rows, on the accelerator ("on a TPU" there, "on CUDA"
    here)."""
    return on_card and deterministic and lkv >= FLASH_MIN_KV


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    dropout_rate: float = 0.0,
                    drop: Optional[DropoutStream] = None) -> torch.Tensor:
    """B13 where ``use_flash_cross`` says so, ``attention`` otherwise.  A
    forward is deterministic when it has no dropout stream."""
    if use_flash_cross(q.device.type == "cuda", drop is None, k.shape[2]):
        return flash_cross_attention(q, k, v, bias)
    return attention(q, k, v, bias, dropout_rate, drop)
