"""Sequence-parallel attention, ring and all-to-all (Ulysses): counterpart
of `alphatriangle_tpu/parallel/ring_attention.py` on `torch.distributed`.

- `ring_attention`: each rank of the sp line holds a sequence shard of
  Q, K and V. The K/V blocks travel the ring (rank i sends to i + 1)
  while each rank folds every block into a float32 online softmax
  (`_fold_block`: running max, normalizer and weighted sum, as the JAX
  fold computes them), so no rank holds the (S, S) scores or the whole
  of K and V. JAX differentiates through `ppermute`; here an
  `autograd.Function` does the backward by hand: the blocks travel the
  ring again, each rank adds its queries' share of every block's dK and
  dV to accumulators that travel with the block, and one last hop
  returns each block's dK and dV to its owner.
- `ulysses_attention`: one all-to-all reshards (B, S/n, H, D) to
  (B, S, H/n, D), dense attention runs on those heads over the whole
  sequence, and a second all-to-all reshards back. The all-to-all is
  its own transpose, so its backward is the same exchange.
- `make_sp_attention` builds the `attention_fn` the model's transformer
  takes (`nn/model.py`): the learner's net runs on its dp rows on every
  sp rank alike, and only the attention core is cut. Each rank takes
  its sequence slice of the replicated q, k and v (`scatter_to_sp`),
  attends, and the outputs are gathered back whole (`gather_from_sp`),
  so every gradient comes out whole and equal on the sp ranks. It
  receives the query unscaled: the scores are scaled in float32 after
  the product (`s * scale`), as in JAX, where Flax scales the query
  inside `dot_product_attention`. Like JAX it refuses a bias, a mask,
  attention-weight dropout in train mode, an unknown kind and Ulysses
  heads that do not divide by sp, and attends densely when the
  sequence does not divide by sp (the same arithmetic, decided from
  the shapes).

Under gloo the ring's sends and receives and the all-to-all go through
host buffers when the tensors are on the card (a transport detail: the
algorithm and the bytes exchanged are the same). The forward and the
ring's and the all-to-all's backward run under the `sp.attention`
record_function label. The matmuls are `torch.einsum` in float32: none
of this is a hand-written kernel, as it is no Pallas kernel in JAX.
"""

import math

import torch
import torch.distributed as dist

from ..config.mesh_config import Mesh
from .sharding import _ALONE, SP, _staged, gather_from_sp, line_group, line_ranks, scatter_to_sp

SP_LABEL = "sp.attention"  # record_function label of the sequence-parallel core


def _fold_block(q, k, v, m, l, o, scale: float):
    """Fold one K/V block into the online-softmax accumulators, all in
    float32. q: (B, Sq, H, D); k, v: (B, Sk, H, D); m (running max), l
    (running normalizer): (B, H, Sq); o (unnormalized output): (B, Sq, H, D)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l = l * alpha + p.sum(dim=-1)
    o = o * alpha.transpose(1, 2)[..., None] + torch.einsum("bhqk,bkhd->bqhd", p, v)
    return m_new, l, o


def _dense_attention(q, k, v, scale: float) -> torch.Tensor:
    """softmax(QK^T * scale)V over (B, S, H, D), accumulated in float32,
    in q's dtype."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.float()).to(q.dtype)


class _Line:
    """This rank's sp line as the transport sees it."""

    def __init__(self, mesh: Mesh):
        self.group = line_group(mesh, SP)
        self.ranks = line_ranks(mesh, SP)
        self.index = mesh.sp_index
        self.n = mesh.sp

    def shift(self, tensors: list) -> list:
        """Each tensor sent to the next rank of the ring; the previous
        rank's received in its place."""
        dst = self.ranks[(self.index + 1) % self.n]
        src = self.ranks[(self.index - 1) % self.n]
        staged = [t.cpu() if _staged(t, self.group) else t.contiguous() for t in tensors]
        recv = [torch.empty_like(t) for t in staged]
        works = []
        for tag, (out, into) in enumerate(zip(staged, recv)):
            works.append(dist.isend(out, dst, group=self.group, tag=tag))
            works.append(dist.irecv(into, src, group=self.group, tag=tag))
        for w in works:
            w.wait()
        return [r.to(t.device) for r, t in zip(recv, tensors)]

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Chunk j of x's leading dim to rank j; out[j] is rank j's chunk
        for this rank."""
        send = x.cpu() if _staged(x, self.group) else x.contiguous()
        out = torch.empty_like(send)
        dist.all_to_all_single(out, send, group=self.group)
        return out.to(x.device)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, line):
        b, sq, h, _ = q.shape
        qf = q.float()
        m = torch.full((b, h, sq), -math.inf, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
        o = torch.zeros(qf.shape, dtype=torch.float32, device=q.device)
        # The local block first, then n - 1 hops: no block travels past
        # its last fold.
        m, l, o = _fold_block(qf, k.float(), v.float(), m, l, o, scale)
        kb, vb = k, v
        for _ in range(line.n - 1):
            kb, vb = line.shift([kb, vb])
            m, l, o = _fold_block(qf, kb.float(), vb.float(), m, l, o, scale)
        out = o / l.transpose(1, 2)[..., None]
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.scale, ctx.line = scale, line
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        scale, line = ctx.scale, ctx.line
        with torch.profiler.record_function(SP_LABEL):
            qf, do = q.float(), dout.float()
            delta = (do * out).sum(dim=-1).transpose(1, 2)  # (B, H, Sq)
            dq = torch.zeros_like(qf)
            kb, vb = k, v
            dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
            dv = torch.zeros_like(dk)
            for hop in range(line.n):
                if hop:
                    kb, vb, dk, dv = line.shift([kb, vb, dk, dv])
                kf, vf = kb.float(), vb.float()
                p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale - lse[..., None])
                dv = dv + torch.einsum("bhqk,bqhd->bkhd", p, do)
                ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, vf) - delta[..., None])
                dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
                dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
            if line.n > 1:
                # This rank holds block index + 1's accumulators: one hop
                # more takes every block's home.
                dk, dv = line.shift([dk, dv])
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line):
        ctx.line = line
        return line.all_to_all(x)

    @staticmethod
    def backward(ctx, grad):
        with torch.profiler.record_function(SP_LABEL):
            return ctx.line.all_to_all(grad.contiguous()), None


def ring_attention(q, k, v, *, mesh: Mesh, scale: "float | None" = None) -> torch.Tensor:
    """Bidirectional ring attention over the sp line: q, k, v are this
    rank's (B, S/n, H, D) sequence shards; returns the (B, S/n, H, D)
    attention of the local queries over the whole sequence, accumulated
    in float32, in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if line_group(mesh, SP) is _ALONE:
        return _dense_attention(q, k, v, scale)
    return _RingAttention.apply(q, k, v, scale, _Line(mesh))


def ulysses_attention(q, k, v, *, mesh: Mesh, scale: "float | None" = None) -> torch.Tensor:
    """All-to-all (Ulysses) attention over the sp line: (B, S/n, H, D)
    shards -> full sequence on H/n heads -> dense attention -> back.
    The head count must divide by sp."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if line_group(mesh, SP) is _ALONE:
        return _dense_attention(q, k, v, scale)
    line = _Line(mesh)
    n = line.n

    def to_heads(x):  # (B, S/n, H, D) -> (B, S, H/n, D)
        b, s, h, d = x.shape
        y = x.reshape(b, s, n, h // n, d).permute(2, 0, 1, 3, 4).contiguous()
        y = _AllToAll.apply(y, line)  # y[j]: rank j's sequence block of these heads
        return y.permute(1, 0, 2, 3, 4).reshape(b, n * s, h // n, d)

    def to_sequence(x):  # (B, S, H/n, D) -> (B, S/n, H, D)
        b, s, hl, d = x.shape
        y = x.reshape(b, n, s // n, hl, d).permute(1, 0, 2, 3, 4).contiguous()
        y = _AllToAll.apply(y, line)  # y[j]: rank j's heads of this sequence block
        return y.permute(1, 2, 0, 3, 4).reshape(b, s // n, n * hl, d)

    out = _dense_attention(to_heads(q), to_heads(k), to_heads(v), scale)
    return to_sequence(out)


def make_sp_attention(mesh: Mesh, kind: str = "ring"):
    """A sequence-parallel `attention_fn` for the model's transformer
    (`nn/model.py` `MultiHeadDotProductAttention`): whole (B, S, H, D)
    query (unscaled), key and value replicated over sp in, the whole
    attention output out."""
    if kind == "ring":
        inner = ring_attention
    elif kind == "ulysses":
        inner = ulysses_attention
    else:
        raise ValueError(f"Unknown sequence-parallel kind: {kind!r}")
    n = mesh.sp

    def attention_fn(query, key, value, bias=None, mask=None, dropout_rate=0.0, deterministic=True):
        if bias is not None or mask is not None:
            raise NotImplementedError("sequence-parallel attention does not support bias/mask")
        if kind == "ulysses" and query.shape[2] % n:
            raise ValueError(
                f"ulysses attention needs head count ({query.shape[2]}) "
                f"divisible by the sp axis size ({n}); use kind='ring'"
            )
        if dropout_rate and not deterministic:
            raise NotImplementedError(
                "sequence-parallel attention does not support attention-"
                "weight dropout; set ATTENTION_DROPOUT=0 or eval mode"
            )
        scale = 1.0 / math.sqrt(query.shape[-1])
        if query.shape[1] % n:
            # A sequence that does not tile the sp line attends densely:
            # the same arithmetic, decided from the shapes.
            return _dense_attention(query, key, value, scale)
        with torch.profiler.record_function(SP_LABEL):
            q, k, v = (scatter_to_sp(t, mesh, 1) for t in (query, key, value))
            return gather_from_sp(inner(q, k, v, mesh=mesh, scale=scale), mesh, 1)

    return attention_fn
