"""Ring attention: sequence parallelism over the mesh's ``seq`` axis.

Port of ``distributed_llm_training_benchmark_framework_tpu/ops/ring_attention.py``.
The sequence is cut into n shards. Each shard keeps its q block while the
k/v blocks rotate around the ring, one hop at a time, so after n hops every
shard has attended to every key. A hop computes one (Sl x Sl) block's
*unnormalized* online-softmax triple (m, l, o) and merges it into the
running one, exactly as the flash kernel merges its own k tiles; the
(S, S) score matrix never exists. The backward is a second ring pass
(Liu et al. 2023): every shard recomputes its blocks' probabilities from
the saved global logsumexp, accumulates dq locally, and rotates
(k, v, dk, dv) a full cycle so that every block's dk/dv land home summed.

Kernels (CUDA C++ for sm_90a; "live" counts the score elements the causal
mask keeps in the block):

==================  ======================================================  ===================
wrapper             replaces (JAX package, ``ops/ring_attention.py``)       bound on the H100
==================  ======================================================  ===================
``ring_fwd_block``  K4 ``_ring_fwd_block_kernel`` (``csrc/ring_fwd.cu``)    4*BH*live*Dh FLOPs
``flash_bwd_dq``    K2′ ``_bwd_dq_kernel`` via ``_block_bwd_kernel``        6*BH*live*Dh FLOPs
                    (``csrc/flash_bwd.cu``)
``flash_bwd_dkv``   K3′ ``_bwd_dkv_kernel`` via ``_block_bwd_kernel``       8*BH*live*Dh FLOPs
                    (``csrc/flash_bwd.cu``)
==================  ======================================================  ===================

K2′ and K3′ are the flash backward kernels (``ops/flash_attention.py``) in
their fp32-output mode: the ring adds n per-hop partials in fp32 and casts
once at the end, as JAX does. All three are Hopper wgmma mainloops with
TMA-fed tile stages and their accumulators in registers (K4 shares K1's
loop, K2′ / K3′ are K2 / K3); each walks only the block's live tiles, and
a block wholly in the q shard's future loads nothing and writes exact
zeros (K4: m = NEG_INF, l = 0, o = 0). With dropout each kernel also
evaluates the coordinate hash per live element, keyed by the GLOBAL
batch*head id and global row and column, so ring and flash draw the same
mask for the same seed whatever the sharding. On CPU tensors the wrappers
run their plain versions (``_block_stats_plain``, the port of
``_block_stats_jnp``, and the flash backward's plain versions, which are
JAX's ``block_bwd``); on CUDA tensors they launch the kernel or raise.
Each launch adds one to its count (``launch_counts``; K2′ and K3′ count as
the backward kernels' fp32 modes). Unlike JAX, whose backward takes the
kernels only from local shards of 4096 up (a TPU v5e crossover), the port
launches them at every shard length.

Two forms share the hop, merge and exchange code (``_ring_fwd`` and
``_ring_bwd`` over a ring "transport"):

- :func:`ring_attention` takes full (B, S, H, Dh) tensors and holds all n
  shards on their one device in one process (``_LocalRing``): every hop is
  a real kernel launch with the real global offsets, and a send hands a
  shard to its neighbour's slot. This is how the JAX package runs its ring
  on virtual devices, and how one card runs the sequence-parallel path.
- :func:`ring_attention_sharded` takes this rank's (B, S/n, H, Dh) shard and
  sends blocks point to point over a ``torch.distributed`` group
  (``_GroupRing``, ``batch_isend_irecv`` in place of ``ppermute``).

Causal rings take the zigzag layout by default (``_zig_exchange``): shard c
holds the global half-chunks c and 2n-1-c, so every shard does about the
same causal work at every hop. Tile bases come per half-chunk, so a tile
never straddles the half boundary; ``lse`` and ``delta`` are zigzag-ordered
inside the ring, and the outputs leave in the contiguous layout.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from . import _build
from . import flash_attention as fa
from .flash_attention import _global_bh_vec

NEG_INF = fa.NEG_INF
TILE = fa.TILE


# ---------------------------------------------------------------------------
# One ring block: K4 and its plain version
# ---------------------------------------------------------------------------


def _block_stats_plain(q3, k3, v3, seed, row_idx, col_idx, bhv, causal: bool,
                       dropout_rate: float):
    """Materialized block with K4's exact semantics (JAX ``_block_stats_jnp``):
    (BH, Sq, Dh) x (BH, Sk, Dh) -> m, l (BH, Sq) fp32 and unnormalized o
    (BH, Sq, Dh) fp32. ``row_idx``/``col_idx`` are per-row GLOBAL positions."""
    D = q3.shape[-1]
    s = torch.matmul(q3.float(), k3.float().transpose(1, 2)) * (1.0 / math.sqrt(D))
    rows = row_idx.to(device=q3.device, dtype=torch.int64)[:, None]
    cols = col_idx.to(device=q3.device, dtype=torch.int64)[None, :]
    if causal:
        mask = rows >= cols
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    if causal:
        p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1)
    if dropout_rate > 0.0:
        bh = bhv.to(device=q3.device, dtype=torch.int64)[:, None, None]
        keep = fa.dropout_keep(seed, bh, rows[None], cols[None], fa.dropout_threshold(dropout_rate))
        p = torch.where(keep, p * (1.0 / (1.0 - dropout_rate)), 0.0)
    o = torch.matmul(p.to(q3.dtype).float(), v3.float())
    return m, l, o


def ring_fwd_block(q, k, v, causal: bool, dropout_rate: float, seed: int, qoff, koff, bhv):
    """K4: one ring block (BH, Sl, Dh) q, k, v -> (m, l) fp32 (BH, Sl) and the
    unnormalized o fp32 (BH, Sl, Dh). ``qoff``/``koff`` are the global bases
    of the block's q / k tiles (64 rows each on the card) and ``bhv`` the
    global batch*head ids."""
    if fa._on_cpu(q):
        return _block_stats_plain(
            q, k, v, seed, fa._tile_coords(qoff, q.shape[1], q.device),
            fa._tile_coords(koff, k.shape[1], q.device), bhv, causal, dropout_rate,
        )
    fa._check_cuda(q, k, v)
    BH, S, D = q.shape
    qo, ko, bv = fa._offset_args(q, qoff, koff, bhv)
    m = torch.empty((BH, S), dtype=torch.float32, device=q.device)
    l = torch.empty((BH, S), dtype=torch.float32, device=q.device)
    o = torch.empty((BH, S, D), dtype=torch.float32, device=q.device)
    dropout, seed32, thr, inv = fa._dropout_args(dropout_rate, seed)
    lib = _build.load()["ring_fwd"]
    code = lib.ring_fwd_block(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(), l.data_ptr(), o.data_ptr(),
        qo.data_ptr(), ko.data_ptr(), bv.data_ptr(), BH, S, D, int(causal), dropout,
        1.0 / math.sqrt(D), seed32, thr, inv, fa._stream(q),
    )
    _build.check("ring_fwd", code, "ring_fwd_block launch")
    _build.launched("ring_fwd_block")
    return m, l, o


# The ring path's kernels by name, and the kernel mode each one counts as.
RING_KERNELS = {
    "ring_fwd_block": "ring_fwd_block",        # K4
    "flash_bwd_dq_ring": "flash_bwd_dq_fp32",  # K2′
    "flash_bwd_dkv_ring": "flash_bwd_dkv_fp32",  # K3′
}


def launch_counts() -> dict:
    """Launches of K4, K2′ and K3′ (the ring path's kernels); reset with
    ``flash_attention.reset_launch_counts``."""
    return {name: _build.LAUNCHES[mode] for name, mode in RING_KERNELS.items()}


# ---------------------------------------------------------------------------
# Coordinates (same names and values as the JAX module)
# ---------------------------------------------------------------------------


def _zig(g: int, n: int) -> int:
    """The shard that holds global half-chunk g in the zigzag layout."""
    return g if g < n else 2 * n - 1 - g


def _zig_chunk_bases(c: int, n: int, h: int) -> Tuple[int, int]:
    """Global start rows of shard ``c``'s two zigzag half-chunks: chunk c and
    chunk 2n-1-c (h tokens each)."""
    return (c * h, (2 * n - 1 - c) * h)


def _bases_to_tiles(bases: Sequence[int], h: int, b: int, device=None) -> torch.Tensor:
    """Per-tile global base vector from per-chunk bases (each chunk h rows,
    tile size b, b | h): concat over chunks of base + arange(h // b) * b."""
    per = h // b
    return torch.cat([
        int(base) + torch.arange(per, dtype=torch.int32, device=device) * b for base in bases
    ])


def _bases_to_rows(bases: Sequence[int], h: int, device=None) -> torch.Tensor:
    """Per-row global index vector from per-chunk bases."""
    return _bases_to_tiles(bases, h, 1, device)


def _ring_perm(n: int) -> List[Tuple[int, int]]:
    return [(j, (j + 1) % n) for j in range(n)]


def _shard_tiles(n: int, Sl: int, zig: bool, device) -> List[torch.Tensor]:
    """Tile-base vector of every shard's block: 64-row tiles where a chunk
    holds whole ones (always on the card), else one row per tile (small CPU
    shapes, which only the plain versions see)."""
    h = Sl // 2 if zig else Sl
    tile = TILE if h % TILE == 0 else 1
    return [
        _bases_to_tiles(_zig_chunk_bases(c, n, h) if zig else (c * Sl,), h, tile, device)
        for c in range(n)
    ]


# ---------------------------------------------------------------------------
# Transports: where the n shards live and how a block moves to a neighbour
# ---------------------------------------------------------------------------


class _LocalRing:
    """Every shard of the ring in this process, on the tensors' one device:
    a ring value is the list of the n shards' tensors, and a send moves a
    tensor to its destination's slot."""

    def __init__(self, n: int):
        self.n = n
        self.ranks = list(range(n))  # the shards this process holds

    def split(self, x: torch.Tensor) -> List[torch.Tensor]:
        return [c.contiguous() for c in x.chunk(self.n, dim=1)]

    def join(self, xs: List[torch.Tensor]) -> torch.Tensor:
        return torch.cat(xs, dim=1)

    def permute(self, xs: List[torch.Tensor], perm) -> List[torch.Tensor]:
        out: List[Optional[torch.Tensor]] = [None] * self.n
        for src, dst in perm:
            out[dst] = xs[src]
        return out


class _GroupRing:
    """One shard per rank of a ``torch.distributed`` group: a ring value is
    [this rank's tensor], and a send is a point-to-point message."""

    def __init__(self, group=None):
        self.group = group if group is not None else dist.group.WORLD
        self.n = dist.get_world_size(self.group)
        self.ranks = [dist.get_rank(self.group)]

    def split(self, x: torch.Tensor) -> List[torch.Tensor]:
        return [x.contiguous()]

    def join(self, xs: List[torch.Tensor]) -> torch.Tensor:
        return xs[0]

    def permute(self, xs: List[torch.Tensor], perm) -> List[torch.Tensor]:
        my = self.ranks[0]
        dst = dict(perm)[my]
        src = {d: s for s, d in perm}[my]
        x = xs[0].contiguous()
        if dst == my:  # a permutation: then src == my too
            return [x]
        buf = torch.empty_like(x)
        ops = [
            dist.P2POp(dist.isend, x, dist.get_global_rank(self.group, dst), self.group),
            dist.P2POp(dist.irecv, buf, dist.get_global_rank(self.group, src), self.group),
        ]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [buf]


def _zig_exchange(ring, xs: List[torch.Tensor], inverse: bool = False) -> List[torch.Tensor]:
    """Redistribute (BH, Sl, ...) half-chunks between the contiguous layout
    (shard c holds chunks 2c, 2c+1) and the zigzag layout (shard c holds
    chunks c, 2n-1-c), with two permutes each way, one per half (JAX
    ``_zig_exchange``)."""
    n = ring.n
    h = xs[0].shape[1] // 2
    lo, hi = [x[:, :h] for x in xs], [x[:, h:] for x in xs]
    even = [my % 2 == 0 for my in ring.ranks]
    if not inverse:
        # contiguous -> zigzag: shard c sends chunk 2c on ring A and chunk
        # 2c+1 on ring B; zigzag shard d's low chunk (d) arrives on A iff d
        # is even, and its high chunk (2n-1-d) on the other.
        recv_a = ring.permute(lo, [(c, _zig(2 * c, n)) for c in range(n)])
        recv_b = ring.permute(hi, [(c, _zig(2 * c + 1, n)) for c in range(n)])
        new_lo = [a if e else b for a, b, e in zip(recv_a, recv_b, even)]
        new_hi = [b if e else a for a, b, e in zip(recv_a, recv_b, even)]
    else:
        # zigzag -> contiguous: ring A carries the EVEN global chunk each
        # shard holds, ring B the odd one; contiguous shard c receives chunk
        # 2c on A (its low half) and 2c+1 on B.
        send_a = [lo_ if e else hi_ for lo_, hi_, e in zip(lo, hi, even)]
        send_b = [hi_ if e else lo_ for lo_, hi_, e in zip(lo, hi, even)]
        new_lo = ring.permute(send_a, [(_zig(2 * c, n), c) for c in range(n)])
        new_hi = ring.permute(send_b, [(_zig(2 * c + 1, n), c) for c in range(n)])
    return [torch.cat([a, b], dim=1) for a, b in zip(new_lo, new_hi)]


# ---------------------------------------------------------------------------
# The ring, forward and backward
# ---------------------------------------------------------------------------


def _ring_fwd(ring, q3, k3, v3, causal, rate, seed, zig, bhv):
    """Forward ring pass over (BH, ·, Dh) tensors (all shards or this rank's)
    -> normalized out (contiguous layout) and the fp32 global logsumexp
    (zigzag-ordered within each shard when ``zig``)."""
    n = ring.n
    qs, ks, vs = ring.split(q3), ring.split(k3), ring.split(v3)
    Sl = qs[0].shape[1]
    if zig:
        # Global coordinates flow through the per-chunk tile bases, so the
        # causal mask and the dropout hash stay bit-identical to flash.
        qs, ks, vs = (_zig_exchange(ring, t) for t in (qs, ks, vs))
    tiles = _shard_tiles(n, Sl, zig, q3.device)
    perm = _ring_perm(n)
    m_run = [torch.full(q.shape[:2], NEG_INF, dtype=torch.float32, device=q.device) for q in qs]
    l_run = [torch.zeros(q.shape[:2], dtype=torch.float32, device=q.device) for q in qs]
    o_run = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    k_cur, v_cur = ks, vs
    for t in range(n):
        for i, my in enumerate(ring.ranks):
            # After t hops the resident k/v block originated on (my - t) % n.
            src = (my - t) % n
            m_b, l_b, o_b = ring_fwd_block(qs[i], k_cur[i], v_cur[i], causal, rate, seed,
                                           tiles[my], tiles[src], bhv)
            # Merge as the kernel merges its own k tiles: rescale both
            # accumulators to the joint max.
            m_new = torch.maximum(m_run[i], m_b)
            a_run, a_b = torch.exp(m_run[i] - m_new), torch.exp(m_b - m_new)
            l_run[i] = l_run[i] * a_run + l_b * a_b
            o_run[i] = o_run[i] * a_run[..., None] + o_b * a_b[..., None]
            m_run[i] = m_new
        if t < n - 1:  # the rotated k/v after the last block would be discarded
            k_cur, v_cur = ring.permute(k_cur, perm), ring.permute(v_cur, perm)
    outs, lses = [], []
    for m, l, o in zip(m_run, l_run, o_run):
        l_safe = torch.where(l == 0.0, 1.0, l)
        outs.append((o / l_safe[..., None]).to(q3.dtype))
        lses.append(m + torch.log(l_safe))
    if zig:
        outs = _zig_exchange(ring, outs, inverse=True)
    return ring.join(outs), ring.join(lses)


def _ring_bwd(ring, q3, k3, v3, out3, lse, do3, causal, rate, seed, zig, bhv):
    """Backward ring pass -> (dq, dk, dv) in the inputs' dtypes: recompute
    every block's probabilities from the saved global logsumexp, accumulate
    dq locally, rotate (k, v, dk, dv) a full cycle so every block's dk/dv
    land home summed. Per-hop partials are fp32 and summed in fp32."""
    n = ring.n
    # delta is a per-row reduction: compute it in the contiguous layout and
    # exchange the (BH, Sl) rows, D times cheaper than exchanging out.
    qs, ks, vs, dos = (ring.split(t) for t in (q3, k3, v3, do3))
    deltas = ring.split(fa.attention_delta(out3, do3))
    lses = ring.split(lse)
    Sl = qs[0].shape[1]
    if zig:
        qs, ks, vs, dos, deltas = (_zig_exchange(ring, t) for t in (qs, ks, vs, dos, deltas))
    tiles = _shard_tiles(n, Sl, zig, q3.device)
    perm = _ring_perm(n)
    f32 = dict(dtype=torch.float32, device=q3.device)
    dq = [torch.zeros(q.shape, **f32) for q in qs]
    dk_cur = [torch.zeros(q.shape, **f32) for q in qs]
    dv_cur = [torch.zeros(q.shape, **f32) for q in qs]
    k_cur, v_cur = ks, vs
    for t in range(n):
        for i, my in enumerate(ring.ranks):
            # Same visit order as the forward; the dk/dv accumulators ride
            # along with the k/v block they belong to. K2′ and K3′ write this
            # block's fp32 partials (JAX _block_bwd_kernel / block_bwd).
            src = (my - t) % n
            args = (qs[i], k_cur[i], v_cur[i], dos[i], lses[i], deltas[i], causal, rate, seed,
                    tiles[my], tiles[src], bhv)
            dq[i] += fa.flash_bwd_dq(*args, out_dtype=torch.float32)
            dk_b, dv_b = fa.flash_bwd_dkv(*args, out_dtype=torch.float32)
            dk_cur[i] += dk_b
            dv_cur[i] += dv_b
        # dk/dv must complete the full cycle (n hops) to land home; k/v are
        # not needed after their last block.
        if t < n - 1:
            k_cur, v_cur = ring.permute(k_cur, perm), ring.permute(v_cur, perm)
        dk_cur, dv_cur = ring.permute(dk_cur, perm), ring.permute(dv_cur, perm)
    if zig:
        dq, dk_cur, dv_cur = (_zig_exchange(ring, t, inverse=True) for t in (dq, dk_cur, dv_cur))
    return (ring.join(dq).to(q3.dtype), ring.join(dk_cur).to(k3.dtype),
            ring.join(dv_cur).to(v3.dtype))


class RingAttentionFunction(torch.autograd.Function):
    """(BH, S or S/n, Dh) ring attention over a transport: the forward ring
    (K4 per hop), then the backward ring (K2′ and K3′ per hop). Saves
    (q, k, v, out, lse, bhv); stands in for JAX's ``custom_vjp``."""

    @staticmethod
    def forward(ctx, q3, k3, v3, ring, causal: bool, rate: float, seed: int, zig: bool, bhv):
        out3, lse = _ring_fwd(ring, q3, k3, v3, causal, rate, seed, zig, bhv)
        ctx.save_for_backward(q3, k3, v3, out3, lse, bhv)
        ctx.ring, ctx.opts = ring, (causal, rate, seed, zig)
        return out3

    @staticmethod
    def backward(ctx, dout3):
        q3, k3, v3, out3, lse, bhv = ctx.saved_tensors
        causal, rate, seed, zig = ctx.opts
        dq, dk, dv = _ring_bwd(ctx.ring, q3, k3, v3, out3, lse, dout3.contiguous(), causal,
                               rate, seed, zig, bhv)
        return dq, dk, dv, None, None, None, None, None, None


# ---------------------------------------------------------------------------
# Public forms
# ---------------------------------------------------------------------------


def _resolve_zigzag(zigzag: Optional[bool], causal: bool, n: int, Sl: int, on_card: bool) -> bool:
    """JAX's layout checks, plus the card's: a chunk (the shard, or a
    zigzag half-chunk) must hold whole 64-row kernel tiles. Auto resolves by
    JAX's rule on every device: a zigzag layout the card cannot tile raises
    (pass zigzag=False) instead of silently running the contiguous one."""
    if zigzag is None:
        zig = causal and n > 1 and Sl % 2 == 0
    else:
        zig = bool(zigzag) and n > 1
        if zig and Sl % 2:
            raise ValueError(
                f"zigzag=True needs an even local shard, got S/sp={Sl} (the layout "
                "splits each shard into two half-chunks)"
            )
    chunk = Sl // 2 if zig else Sl
    if on_card and chunk % TILE:
        raise ValueError(
            f"the ring kernels tile a chunk in {TILE}-row tiles; the local chunk {chunk} "
            f"(S/sp={Sl}" + (", halved by the zigzag layout)" if zig else ")")
            + f" is not a multiple of {TILE}"
            + ("; zigzag=False keeps whole shards" if zig and Sl % TILE == 0 else "")
        )
    return zig


def ring_attention(q, k, v, causal: bool = False, dropout_rate: float = 0.0,
                   dropout_seed: Optional[int] = None, seq_shards: int = 1,
                   zigzag: Optional[bool] = None, batch_offset: int = 0,
                   head_offset: int = 0, n_heads: Optional[int] = None) -> torch.Tensor:
    """Ring attention over full (B, S, H, Dh) tensors -> (B, S, H, Dh).

    Cuts the sequence into ``seq_shards`` shards, all held on the tensors'
    device in this process, and runs the ring over them (JAX
    ``ring_attention`` under a mesh whose ``seq`` axis has that width). With
    ``seq_shards == 1`` it is :func:`flash_attention`, as JAX falls back
    without a ``seq`` axis. ``zigzag``: None (auto: on for causal rings with
    even shards), True or False. Dropout (``dropout_rate`` with a uint32
    ``dropout_seed``) draws flash's global-coordinate mask, keyed from the
    global batch index ``batch_offset`` of row 0 and the global index
    ``head_offset`` of head 0 of ``n_heads`` (a head shard's), as in flash."""
    if seq_shards == 1:
        return fa.flash_attention(q, k, v, causal=causal, dropout_rate=dropout_rate,
                                  dropout_seed=dropout_seed, batch_offset=batch_offset,
                                  head_offset=head_offset, n_heads=n_heads)
    B, S, H, D = q.shape
    if seq_shards < 1 or S % seq_shards:
        raise ValueError(f"sequence length {S} does not split into seq_shards={seq_shards}")
    rate, seed = fa._resolve_dropout(dropout_rate, dropout_seed, "ring_attention")
    zig = _resolve_zigzag(zigzag, causal, seq_shards, S // seq_shards, q.device.type == "cuda")
    bhv = _global_bh_vec(B, H, batch_offset, head_offset, n_heads or H, q.device)
    out3 = RingAttentionFunction.apply(
        fa._to_bhsd(q), fa._to_bhsd(k), fa._to_bhsd(v), _LocalRing(seq_shards), causal, rate,
        seed, zig, bhv,
    )
    return fa._from_bhsd(out3, B, H)


def ring_attention_sharded(q, k, v, group=None, causal: bool = False,
                           dropout_rate: float = 0.0, dropout_seed: Optional[int] = None,
                           zigzag: Optional[bool] = None, batch_offset: int = 0,
                           head_offset: int = 0, n_heads: Optional[int] = None) -> torch.Tensor:
    """Ring attention on this rank's (B, S/n, H, Dh) sequence shard, rank r of
    ``group`` (default: the world) holding shard r; blocks move between ranks
    point to point. Same options and result as :func:`ring_attention`, one
    shard per rank (JAX ``ring_attention_sharded`` inside ``shard_map``).
    ``batch_offset`` is the global batch index of row 0 (the rank's place on
    ``data`` times its rows), which keys the dropout mask as JAX's
    ``_ring_offsets`` does for ``batch_axis``: without it every ``data`` rank
    of a (data, seq) mesh would draw the same mask for other examples.
    ``head_offset`` / ``n_heads`` do the same for ``heads_axis``: the global
    index of head 0 and the layer's head count under tensor parallelism
    (default: these H heads are all of them)."""
    ring = _GroupRing(group)
    B, Sl, H, D = q.shape
    rate, seed = fa._resolve_dropout(dropout_rate, dropout_seed, "ring_attention_sharded")
    zig = _resolve_zigzag(zigzag, causal, ring.n, Sl, q.device.type == "cuda")
    bhv = _global_bh_vec(B, H, batch_offset, head_offset, n_heads or H, q.device)
    out3 = RingAttentionFunction.apply(
        fa._to_bhsd(q), fa._to_bhsd(k), fa._to_bhsd(v), ring, causal, rate, seed, zig, bhv,
    )
    return fa._from_bhsd(out3, B, H)
