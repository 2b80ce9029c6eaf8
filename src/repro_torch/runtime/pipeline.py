"""Serdab pipelined serving: stages in sequence on one card, or one stage
per rank.

Port of ``repro/runtime/pipeline.py``. The block stack is split into
``num_stages`` contiguous stages (block counts from the placement
solver, uneven ones included) and the decode batch into
``num_microbatches`` microbatches: rows ``[m * B_mb, (m + 1) * B_mb)``
form microbatch m, with ``B_mb = num_slots / num_microbatches``.
Microbatch m leaves stage s at tick ``t = m + s``; its ``[B_mb, 1, d]``
activation is sealed there under the step's key and the counter
``_leaf_counter(t + 1, s)`` (int8 quantize + keystream XOR, the paper's
enclave-to-enclave discipline) and opened by stage s + 1 under the same
pair. With two stages that is the reference's ``seal_array(h, key, t +
1)``, byte for byte; with three or more the reference seals every stage
under leaf 0, so stage s's microbatch m + 1 and stage s + 1's microbatch
m would share a keystream, and the port gives each stage a leaf of its
own. The step takes its key as a one-element device tensor, and the
per-tick counters, fixed for a layout, are built once as a device tensor
(``sealing.leaf_counters``), so the step can be captured in a CUDA
graph: each replay seals under the key the engine copied in for it.
Stage 0 embeds instead of unsealing; the last stage applies the final
norm and the f32 head, unsealed.

Both KV layouts run here: the paged pools (``build(paged=True)``) and the
reference's shared-position timeline (``build(paged=False)``: a cache
body ``[L, B, KVH, S, D]``, one ``len`` for every row and a per-slot
``start`` mask, ``per_slot_start``).

What the reference does for sharding over pods and the port does not copy
on one card (without ``mesh``):

* the staged ``[S, bps, ...]`` parameter and cache layout with its padding
  masks: the pools and the timeline body keep one layer per row of their
  leading dim and a stage is a range of layers, so staging a cache is
  the identity and ``restage_cache`` on a live boundary swap moves
  nothing;
* the warm-up and drain ticks, whose outputs the reference masks out: only
  the ``nm * S`` valid (microbatch, stage) pairs run, in tick order, which
  makes ``nm * (S - 1)`` seals and as many unseals per step;
* the ``ppermute`` ring between pods: a sealed payload stays on the card
  between its seal and its unseal.

With ``mesh=`` (a ``DeviceMesh`` of the world's ranks from ``make_mesh``
inside ranks that ``launch.ranks.spawn`` started: axes ``pod``, ``data``
and ``model``, ``pod`` of ``num_stages``) stage s runs on the ranks of pod s,
the reference's layout. ``stage_params`` / ``stage_cache`` /
``stage_paged_cache`` keep a rank's own layers only (and the embedding on
stage 0, the final norm and head on the last). Microbatch m still meets
stage s at tick ``m + s``: stage s takes its microbatches in order,
receives each from stage s - 1, runs it, and posts it to stage s + 1
sealed under the step's key and the counter of tick ``m + s + 1`` (raw
without sealing) as a message (``launch.ranks``: through pinned host
memory under gloo), so a payload leaves its enclave only as cipher text.
The ``data`` ranks of a pod split each microbatch's rows evenly, as the
reference's pipelined step shards ``act_batch`` over ``data`` inside a
stage: data rank d takes the d-th block of ``B_mb / data`` rows and
stage s seals it under leaf ``s * data + d`` (``boundary_counters``), so
no two activations share a (key, counter) pair (with one data rank the
counters, and the cipher, are the one-card path's). A microbatch whose
rows the data ranks do not divide runs whole on each of them, as the
reference's rule falls back to replication. The reference keeps a pod's
pools whole on each of its data devices; here each data rank keeps its
stage's whole cache and writes its own rows' entries in a step, and
after the step's ticks the data ranks of a pod exchange those entries
(each row's K and V at the (page, offset) it wrote, or the timeline
body's rows at the step's slot), sealed with the page cipher under
sequence numbers of their own (``sealing.exchange_seq``): after every
step the data ranks of a pod hold one cache, bit for bit. The last
stage's logits reach every rank (a broadcast over ``pod``, then a gather
over ``data``), so the step returns the one-card path's [B, V].

A CUDA graph cannot post or wait on a message, so the rank step is split
into segments that touch the device only (``rank_segments``): a
microbatch's stage work (``tick``: embed or unseal, the layers, then seal
or the head), the exchange's ``take`` (this rank's entries, sealed) and
the step's ``tail`` (the peers' entries unsealed and written, then
``seq_lens`` or ``len`` advanced). ``rank_loop`` runs them in order on
the host and posts the messages between them; an engine puts each
segment under graph management (``serving/ranked.py``), ``build`` runs
them eagerly. Per-call numbers reach a segment as device tensors (the
step key, the exchange's key and counters); the host ints among its
arguments (the microbatch, the batch size) select its graph.

A ``model`` axis above 1 (ROADMAP item 10d, step 5c; the dense and MoE
``StackedLM``) splits each stage's layers over the model ranks of its
pod, tensor parallelism inside the enclave: each rank keeps its block of
its stage's params (``model_block``: ``PARAM_RULES`` on the whole mesh,
every leaf whole over data) and of its pools (``kv_block``: its KV heads
where they divide, else all of them, and on a rank engine's timeline its
block of the positions where the heads do not divide and the horizon
does), and its layers run under ``context()`` (``PIPE_RULES``, the
reference's pipelined body), whose collectives join the model group. The
activation leaving a stage is whole on every model rank after the last
reduce: model rank 0 of (s, d) alone seals it, under the counters above,
and sends it to model rank 0 of (s + 1, d), which opens it and
broadcasts the plaintext over its model group (``TP.from_lead``), so a
crossing keeps its bytes and (key, counter)s and plaintext moves only
inside a pod. The KV exchange and a restage run between the ranks of
one model index, each sealing its own blocks under sequence numbers of
its own (``exchange_counters``, ``_move_layers``: the numbers at one
model rank times the model axis, plus its index).

Two more pieces serve an engine whose stages are ranks
(``ServingEngine(mesh=)``, pod, data and model ranks):

* ``rank_forward`` runs this rank's layers of a prefill (one-shot, packed,
  chunked or one token: a ``crossing_segment``, which also opens the
  hidden state it receives and seals the one it sends) between its
  neighbours: every data rank of a pod
  runs the whole batch (so their pages stay equal without an exchange),
  takes the hidden state from stage s - 1's rank of its data index and
  posts its own to stage s + 1's, each crossing sealed with the lossless
  page cipher under a counter of its own (``sealing.crossing_seq``),
  never with the int8 seal: the reference runs its prefill on the whole
  params, so a lossy crossing would change its streams. Unsealed with
  ``seal_boundary`` off, as the decode boundary. The last stage's logits
  reach every rank.
* ``restage_cache`` on a live re-plan moves the layers that change owner
  between the ranks of one data index: their pool rows (paged) or body
  rows (timeline) go sealed with the page cipher under counters of their
  own (``sealing.restage_seq``, distinct for each data index); what a
  rank keeps stays in place. The result is the cache staged directly
  under the new boundaries.

Each stage reads and writes only its own layers of the shared pools, for
its microbatch's block-table rows; ``seq_lens`` advance once per step,
for every row that holds a sequence. On the timeline a stage writes its
layers' rows of its microbatch at the shared position ``len``, which
advances once per step.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.enclave import sealing
from repro_torch.kernels import ops as K
from repro_torch.kernels.seal import int_dtype_of
from repro_torch.launch import ranks as RK
from repro_torch.models.api import ModelAPI
from repro_torch.models.layers import paged_write_targets
from repro_torch.sharding import rules as R
from repro_torch.sharding import tensor_parallel as TP
from repro_torch.tree import leaves, map_tree


# restage sequence numbers one restage may take (``restage_cache``)
RESTAGE_SEQS = 256
# a rank's blocks on a pod x data x model mesh: the params' under
# PARAM_RULES with every leaf whole over data (a pod's data ranks hold
# whole params), the caches' under the pipelined body's rules with the
# rows whole over data (a pod's data ranks hold one cache)
PIPE_PARAM_RULES = R.merge_rules(R.PARAM_RULES, {"embed": [()]})
PIPE_KV_RULES = R.merge_rules(R.PIPE_RULES, {"act_kv_batch": [()]})
# logical axes of a paged pool [L, N, KVH, Pg, D] (the reference's
# per-layer (None, "act_kv_heads", None, None))
PAGED_AXES = ("layers", None, "act_kv_heads", None, None)


def _cipher_dtype(t: torch.Tensor) -> torch.dtype:
    """The float type whose bits the page cipher moves ``t`` as: its own
    for f32 and bf16, bf16 (two bytes an element) for anything else."""
    return t.dtype if t.dtype in (torch.float32, torch.bfloat16) \
        else torch.bfloat16


def _cipher_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` [rows, ...] as a contiguous 2D float view of its bits."""
    t = t.contiguous()
    if t.dtype in (torch.float32, torch.bfloat16):
        return t.reshape(t.shape[0], -1)
    return t.view(torch.uint8).reshape(t.shape[0], -1).view(torch.bfloat16)


def _cipher_like(t: torch.Tensor, rows: int) -> torch.Tensor:
    """An empty cipher of ``rows`` layers of ``t``'s kind (a receive's
    shape and type)."""
    per = _cipher_rows(t[:1]).shape[1]
    return torch.empty((rows, per), device=t.device,
                       dtype=int_dtype_of(_cipher_dtype(t)))


def _from_cipher(rows: torch.Tensor, like: torch.Tensor,
                 n: int) -> torch.Tensor:
    """The inverse of ``_cipher_rows``: opened rows back to ``n`` layers
    shaped and typed as ``like``'s."""
    shape = (n,) + tuple(like.shape[1:])
    if like.dtype in (torch.float32, torch.bfloat16):
        return rows.reshape(shape)
    return rows.view(torch.uint8).view(like.dtype).reshape(shape)


def pipeline_applicable(api: ModelAPI) -> bool:
    """The reference's test: a model of one homogeneous segment (not
    moonshot's dense stem ahead of its MoE blocks)."""
    model = api.model
    return hasattr(model, "segments") and len(model.segments) == 1


@dataclasses.dataclass
class PipelinedDecoder:
    """Builds the pipelined decode step of one stage layout: with no mesh
    the stages run one after another on ``api.device``; with a mesh of
    ranks this rank runs its pod's stage (see the module's docstring)."""

    api: ModelAPI
    num_stages: int
    num_microbatches: int
    seal_boundary: bool = True
    stage_blocks: Optional[Sequence[int]] = None   # per-stage block counts
    stage_devices: Optional[Sequence[str]] = None  # per-stage device names
    mesh: Any = None                               # a DeviceMesh of ranks
    # on ranks, whether its crossings, restages and exchanges draw from
    # the sequence spaces of a pair's prefill role (``sealing``)
    prefill_role: bool = False

    @classmethod
    def from_spec(cls, api: ModelAPI, spec, num_microbatches: int, *,
                  mesh=None, **kw) -> "PipelinedDecoder":
        """A decoder straight from a planner ``PlacementSpec``: stage s runs
        segment s (``spec.segments[s]``). The spec's device order is the
        pipeline order; the trust domain changes what the cost model
        charged, not how a stage runs. The spec places the served
        segment's blocks (the engine's ``block_profiles``)."""
        n = api.model.served_segment.n
        assert spec.num_layers == n, (spec.num_layers, n)
        return cls(api, num_stages=spec.num_segments,
                   num_microbatches=num_microbatches,
                   stage_blocks=spec.stage_sizes(),
                   stage_devices=spec.devices(), mesh=mesh, **kw)

    def __post_init__(self):
        assert pipeline_applicable(self.api), \
            "pipelined serve needs a single homogeneous segment"
        n, S = self.api.model.served_segment.n, self.num_stages
        if self.stage_blocks is None:
            assert n % S == 0, \
                f"{n} blocks not divisible into {S} stages; pass " \
                f"stage_blocks= for uneven boundaries"
            counts = (n // S,) * S
        else:
            counts = tuple(int(c) for c in self.stage_blocks)
            assert len(counts) == S, (counts, S)
            assert all(c > 0 for c in counts), counts
            assert sum(counts) == n, (counts, n)
        if self.stage_devices is not None:
            self.stage_devices = tuple(self.stage_devices)
            assert len(self.stage_devices) == S, (self.stage_devices, S)
        self.stage_counts = counts
        starts = [0]
        for c in counts:
            starts.append(starts[-1] + c)
        # stage s runs layers [ranges[s][0], ranges[s][1])
        self.ranges: Tuple[Tuple[int, int], ...] = tuple(
            (starts[s], starts[s + 1]) for s in range(S))
        if self.mesh is not None:
            self._place_on_ranks()

    # -- a stage per rank ----------------------------------------------------
    def _place_on_ranks(self) -> None:
        from repro_torch.launch.mesh import LOCAL, rank_axes
        sizes = R.mesh_axis_sizes(self.mesh)
        if not R.is_device_mesh(self.mesh) \
                or any(k > 1 for a, k in sizes.items()
                       if a not in ("pod", "data", "model")) \
                or sizes.get("pod") != self.num_stages:
            raise ValueError(
                f"PipelinedDecoder(mesh=): a DeviceMesh of ranks over pod "
                f"(= num_stages {self.num_stages}), data and model, got "
                f"{sizes}")
        ax = rank_axes(self.mesh)
        self.stage, self.data = ax.index("pod"), ax.index("data")
        self.num_data = ax.size("data")
        # the model axis: this rank's blocks of its layers, the group's
        # messages inside the stage (``sharding.tensor_parallel``)
        self.model, self.num_model = ax.index("model"), ax.size("model")
        self.lead = self.model == 0     # seals and sends the crossings
        self._coords = ax.coords
        if self.num_model > 1:
            from repro_torch.runtime.steps import check_model_axis, leaf_block
            check_model_axis(self.api, self.num_model,
                             "PipelinedDecoder(mesh=)")
            self._pcuts = {k: [leaf_block(sp, self.mesh, ax.coords,
                                          PIPE_PARAM_RULES)
                               for sp in leaves(v)]
                           for k, v in self.api.param_specs().items()}
        self._pod_group, self._data_group = ax.group("pod"), ax.group("data")
        # the model group, and this pod's (data, model) ranks (the data
        # group where the model axis is 1)
        self._model_group, self._local_group = ax.group("model"), \
            ax.group(LOCAL)
        self._pod_ranks = RK.group_ranks(self._pod_group)
        self._data_ranks = RK.group_ranks(self._data_group)
        names = tuple(self.mesh.mesh_dim_names)
        # the global rank of (pod s, data 0), for each stage s
        self.stage_leads = [int(self.mesh.mesh[tuple(
            s if n == "pod" else 0 for n in names)])
            for s in range(self.num_stages)]
        self.staging = RK.Staging()
        # the KV exchange's own buffers and byte count: ``staging`` counts
        # what crosses a stage boundary
        self.exchange_staging = RK.Staging()
        self.last_exchange: Optional[Tuple[float, int]] = None
        # host ms of the last rank step in its segments and its messages
        self.last_split: Optional[Tuple[float, float]] = None
        self._row_blocks: Dict[Tuple[int, int], torch.Tensor] = {}

    def splits(self, rows: int) -> bool:
        """Whether the data ranks split a microbatch of ``rows`` rows: with
        more than one data rank and rows a multiple of their count. Else
        every data rank runs the whole microbatch, as the reference's
        ``act_batch`` rule falls back to replication when the data axis
        does not divide the rows."""
        return self.num_data > 1 and rows % self.num_data == 0

    def _rows_of(self, d: int, B: int) -> torch.Tensor:
        """The batch rows data rank ``d`` runs in a step of ``B`` rows (its
        block of every microbatch), on the model's device; made at the
        first call (an eager run: a segment runs once before its capture)
        and kept, since a host-to-device copy cannot be captured."""
        rows = self._row_blocks.get((d, B))
        if rows is None:
            nm = self.num_microbatches
            B_mb = B // nm
            b = B_mb // self.num_data
            rows = self._row_blocks[(d, B)] = (
                torch.arange(nm)[:, None] * B_mb + d * b
                + torch.arange(b)).reshape(-1).to(self.api.device)
        return rows

    def _block(self, B: int) -> Tuple[int, int]:
        """(rows, first row) of this rank's block of a microbatch in a step
        of ``B`` rows: its share where the data ranks split them, else the
        whole microbatch."""
        B_mb = B // self.num_microbatches
        if not self.splits(B_mb):
            return B_mb, 0
        b = B_mb // self.num_data
        return b, self.data * b

    def _local(self, s: int) -> Tuple[int, int]:
        """Stage s's layer range in the params and cache it runs on: its
        range of the whole stack on one card, its own layers (from 0) on a
        rank."""
        if self.mesh is None:
            return self.ranges[s]
        return 0, self.stage_counts[s]

    def _cut(self, tree, device=None):
        lo, hi = self.ranges[self.stage]
        return map_tree(lambda t: t[lo:hi].to(device or t.device,
                                              copy=True), tree)

    def model_block(self, name: str, tree):
        """This rank's block over the model axis of each leaf of
        ``params[name]`` (whole over model; a stacked segment's leaves may
        hold any range of its layers, which no block cuts): the leaf's
        ``leaf_block`` under ``PIPE_PARAM_RULES`` (``PARAM_RULES`` with
        the data axis keeping every leaf whole, as a pod's data ranks hold
        whole params), as views. ``tree`` itself off a model axis."""
        if self.mesh is None or self.num_model == 1:
            return tree
        cuts = iter(self._pcuts[name])

        def cut(t):
            b = next(cuts)
            return t if b is None else t[b]

        return map_tree(cut, tree)

    def kv_block(self, tree, paged: bool, positions: bool = False):
        """This rank's block over the model axis of a cache tree of stacked
        layer leaves whole over model (the paged pools ``(k, v)`` [L, N,
        KVH, Pg, D] or a timeline body): its KV heads where they divide
        (the reference's ``act_kv_heads``), else all of them, and with
        ``positions`` its block of a timeline's positions where the KV
        heads do not divide and the positions do (``act_kv_seq``), as
        views. ``tree`` itself off a model axis."""
        if self.mesh is None or self.num_model == 1:
            return tree
        if paged:
            axes = iter([PAGED_AXES] * len(leaves(tree)))
        else:
            axes = iter(axes_leaves(self.api.model.init_cache_axes()[
                self.api.model.served_segment.name]))
        rules = PIPE_KV_RULES if positions else R.merge_rules(
            PIPE_KV_RULES, {"act_kv_seq": [()]})

        def cut(t):
            sh = R.logical_sharding(t.shape, next(axes), self.mesh, rules)
            return t[sh.block(t.shape, self._coords)]

        return map_tree(cut, tree)

    def positions_split(self, horizon: int) -> int:
        """``horizon`` where a timeline cache of ``horizon`` positions
        holds this rank's block of them (``kv_block(positions=True)``):
        the KV heads do not divide over the model axis and the positions
        do; else 0."""
        split = self.mesh is not None and self.num_model > 1 and \
            TP.kv_seq_splits(self.mesh, PIPE_KV_RULES,
                             self.api.cfg.num_kv_heads, horizon)
        return horizon if split else 0

    def context(self, positions: int = 0):
        """The rule context this rank's model code runs in: the model
        axis's (``PIPE_RULES``, the reference's pipelined body; with
        ``positions``, a ``positions_split`` horizon, its timeline caches
        hold the rank's block of those positions, ``TP.kv_positions``),
        nothing off a model axis."""
        stack = contextlib.ExitStack()
        if self.mesh is not None and self.num_model > 1:
            stack.enter_context(R.axis_rules(self.mesh, R.PIPE_RULES))
            stack.enter_context(TP.kv_positions(positions))
        return stack

    def stage_params(self, params, device=None):
        """This rank's params: its stage's layers of the served segment,
        the embedding on stage 0 (and on the last stage when the head is
        tied to it), the final norm and head on the last stage, anything
        else (a frontend) on stage 0, each leaf's block over the model
        axis (``model_block``); copied to ``device`` when given (a rank
        engine cuts them from its host copy of the whole tree). The whole
        tree on one card."""
        if self.mesh is None:
            return params
        seg = self.api.model.served_segment.name
        first, last = self.stage == 0, self.stage == self.num_stages - 1
        keep = {"embed": first or (last and self.api.cfg.tie_embeddings),
                "ln_f": last, "head": last}
        lo, hi = self.ranges[self.stage]
        return {k: map_tree(lambda t: t.to(device or t.device, copy=True),
                            self.model_block(k, map_tree(lambda t: t[lo:hi],
                                                         v)))
                if k == seg else map_tree(lambda t: t.to(device or t.device),
                                          self.model_block(k, v))
                for k, v in params.items()
                if k == seg or keep.get(k, first)}

    def stage_paged_cache(self, cache):
        """This rank's paged cache: its stage's layers of the pools (its KV
        heads over a model axis, ``kv_block``), the whole block tables and
        seq_lens. The dict itself on one card."""
        if self.mesh is None:
            return cache
        seg = self.api.model.served_segment.name
        return dict(cache, **{seg: self._cut(self.kv_block(cache[seg],
                                                           paged=True))})

    # -- the timeline cache's staging (the identity on one card) -------------
    def stage_cache(self, cache):
        """A timeline cache dict -> the staged pair ``(body, len)``. The
        body keeps its ``[L, B, ...]`` layout: stage s reads its layer range
        of it. On a rank, the body holds the stage's layers only (its KV
        heads over a model axis, every position)."""
        body = cache[self.api.model.served_segment.name]
        return (body if self.mesh is None else self._cut(
            self.kv_block(body, paged=False))), cache["len"]

    def unstage_cache(self, staged, new_len):
        """The inverse of ``stage_cache``."""
        return {self.api.model.served_segment.name: staged, "len": new_len}

    def restage_cache(self, cache, new_dec: "PipelinedDecoder", *,
                      key: int = 0, seq: int = 0):
        """Carry a cache over to ``new_dec``'s boundaries (a live re-plan
        swap): the paged cache dict, or the timeline's staged tuple
        ``(body, len)`` or ``(body, len, start)``, returned in the same
        form. On one card pools and bodies keep one layer per row of their
        leading dim whatever the stage layout, so nothing moves: the cache
        is valid under the new ranges as it is. On ranks this rank's
        layers of the pools or body become its layers under the new
        ranges (``_move_layers``), sealed under ``key`` and the restage
        sequence numbers ``seq``, ``seq + 1``, ... (at most
        ``RESTAGE_SEQS`` of them); block tables, seq_lens, ``len`` and
        ``start`` are whole on every rank and stay."""
        n = self.api.model.served_segment.n
        assert new_dec.api.model.served_segment.n == n
        if self.mesh is None:
            return cache
        assert new_dec.mesh is not None and new_dec.stage == self.stage
        seg = self.api.model.served_segment.name
        if isinstance(cache, dict):
            return dict(cache, **{seg: self._move_layers(cache[seg], new_dec,
                                                         key, seq)})
        return (self._move_layers(cache[0], new_dec, key, seq),) + \
            tuple(cache[1:])

    def _moves(self, new_dec: "PipelinedDecoder"):
        """Every (source stage, destination stage, first layer, end layer)
        of a restage to ``new_dec``: the layers the source owns now and the
        destination owns after, in one order every rank computes."""
        out = []
        for a, (alo, ahi) in enumerate(self.ranges):
            for b, (blo, bhi) in enumerate(new_dec.ranges):
                lo, hi = max(alo, blo), min(ahi, bhi)
                if a != b and lo < hi:
                    out.append((a, b, lo, hi))
        return out

    def _move_layers(self, tree, new_dec: "PipelinedDecoder", key: int,
                     seq: int):
        """This rank's tree of stacked layer leaves (its old range) ->
        the same tree over its new range: the layers it keeps stay, the
        ones it loses go to their new owners and the ones it gains come
        from their old owners, each leaf's slab of a message sealed with
        the page cipher (its bytes viewed as bf16 rows when it is not a
        float: an int8 cache) under its own restage counter."""
        s = self.stage
        (olo, ohi), (nlo, nhi) = self.ranges[s], new_dec.ranges[s]
        flat = leaves(tree)
        moves = self._moves(new_dec)
        assert len(moves) * len(flat) <= RESTAGE_SEQS, \
            (len(moves), len(flat))

        def ctr(m: int, j: int):
            # each (data, model) rank moves its own blocks: a sequence
            # number of its own (the one-model-rank numbers at model 1)
            return sealing._swap_counter(sealing.restage_seq(
                ((seq + m * len(flat) + j) * self.num_data + self.data)
                * self.num_model + self.model, self.prefill_role), 0)

        outgoing, incoming = [], []
        for m, (a, b, lo, hi) in enumerate(moves):
            if a == s:
                outgoing.append((self._pod_ranks[b], [
                    K.seal_bits(_cipher_rows(t[lo - olo:hi - olo]), key,
                                ctr(m, j)) for j, t in enumerate(flat)]))
            elif b == s:
                incoming.append((self._pod_ranks[a], [
                    _cipher_like(t, hi - lo) for t in flat]))
        got = iter(RK.transfer(self.staging, outgoing, incoming,
                               self._pod_group, tag="restage"))
        pieces = {}                        # first layer -> its leaves
        for m, (a, b, lo, hi) in enumerate(moves):
            if b == s:
                pieces[lo] = [_from_cipher(K.unseal_bits(
                    c, key, ctr(m, j), out_dtype=_cipher_dtype(t)), t,
                    hi - lo) for j, (c, t) in enumerate(zip(next(got),
                                                            flat))]
        keep_lo, keep_hi = max(olo, nlo), min(ohi, nhi)
        if keep_lo < keep_hi:
            pieces[keep_lo] = [t[keep_lo - olo:keep_hi - olo] for t in flat]
        new = [torch.cat([pieces[lo][j] for lo in sorted(pieces)])
               for j in range(len(flat))]
        assert all(t.shape[0] == nhi - nlo for t in new), (nlo, nhi)
        it = iter(new)
        return map_tree(lambda _: next(it), tree)

    # -- a prefill stage on a rank --------------------------------------------
    def crossing_counters(self, seq: int) -> List[int]:
        """The page-cipher counters of one prefill call's crossings on this
        rank, ``[in, out]``: the crossing from stage i to i + 1 on data
        rank d seals under the crossing sequence number ``(seq + i) *
        data + d`` (``sealing.crossing_seq``; ``seq + i`` with one data
        rank), so a call takes ``num_stages - 1`` of them a data rank; 0
        where this rank has no such crossing."""
        S, s = self.num_stages, self.stage

        def ctr(i: int) -> int:
            if not 0 <= i < S - 1:
                return 0
            return sealing._swap_counter(sealing.crossing_seq(
                (seq + i) * self.num_data + self.data, self.prefill_role), 0)

        return [ctr(s - 1), ctr(s)]

    def crossing_segment(self, run: Callable) -> Callable:
        """This rank's device work of one prefill call, message-free:
        ``segment(shape, got, key, ctr, *inputs) -> (out, extra)`` opens
        ``got``, the hidden state [rows, d_model] received from stage s -
        1 (None on stage 0), under ``key`` and ``ctr[0]`` into [*shape,
        d_model], runs ``run(x, *inputs) -> (out, extra)`` (``out`` the
        hidden state, or the f32 logits on the last stage) and, on a stage
        that sends, seals ``out`` as [rows, d_model] under ``ctr[1]`` (the
        lossless page cipher; raw with ``seal_boundary`` off). Over a
        model axis only model rank 0 receives, opens, seals and sends: it
        broadcasts the opened hidden state over its model group
        (``TP.from_lead``), and the others return None for ``out`` on a
        stage that sends."""
        api, S, s = self.api, self.num_stages, self.stage
        d = api.cfg.d_model

        def segment(shape, got, key, ctr, *inputs):
            x = None
            if got is not None:
                if self.seal_boundary:
                    got = K.unseal_bits(got, key, ctr[0:1],
                                        out_dtype=api.dtype)
                x = got.reshape(*shape, d)
            if s > 0:
                x = TP.from_lead(x, (*shape, d), api.dtype, api.device)
            out, extra = run(x, *inputs)
            if s < S - 1:
                if not self.lead:
                    return None, extra
                out = out.reshape(-1, d)
                if self.seal_boundary:
                    out = K.seal_bits(out, key, ctr[1:2])
            return out, extra

        return segment

    def rank_forward(self, segment: Callable, shape: Tuple[int, ...],
                     logits_rows: int, key, ctr, *inputs):
        """This rank's layers of one prefill call between its neighbours:
        ``segment`` (a ``crossing_segment``, or a managed call of one) on
        the hidden state [*shape, d_model] received from stage s - 1 (none
        on stage 0, which embeds), its output posted to stage s + 1.
        Every data rank of a pod runs the whole batch: it receives from
        the previous pod's rank of its data index and sends to the next
        one's, the crossing sealed under ``key`` and ``ctr``
        (``crossing_counters``, on the device). Returns (the last stage's
        f32 logits [logits_rows, V] on every rank, the segment's
        ``extra``). A rank that sends a crossing keeps its host ms (from
        the sealed payload ready on the device to the send complete:
        staging and transport) and bytes in ``last_crossing``."""
        api, S, s = self.api, self.num_stages, self.stage
        d, V = api.cfg.d_model, api.cfg.vocab_size
        dev = api.device
        got = None
        if s > 0 and self.lead:
            like = torch.empty((math.prod(shape), d), device=dev, dtype=(
                int_dtype_of(api.dtype) if self.seal_boundary
                else api.dtype))
            got = RK.recv(self.staging, [like], self._pod_ranks[s - 1],
                          self._pod_group, tag="hidden_in").wait()[0]
        out, extra = segment(tuple(shape), got, key, ctr, *inputs)
        if s < S - 1:
            if self.lead:
                self._sync()
                t0, sent0 = time.perf_counter(), self.staging.sent
                RK.send(self.staging, [out], self._pod_ranks[s + 1],
                        self._pod_group, tag="hidden_out").wait()
                self.last_crossing = ((time.perf_counter() - t0) * 1e3,
                                      self.staging.sent - sent0)
            out = torch.empty((logits_rows, V), dtype=torch.float32,
                              device=dev)
        RK.broadcast(self.staging, out, self._pod_ranks[-1], self._pod_group,
                     tag="prefill_logits")
        return out, extra

    def _sync(self) -> None:
        if self.api.device.type == "cuda":
            torch.cuda.synchronize(self.api.device)

    # -- one stage on one microbatch (the tick body and the probe) ----------
    def _pos3(self, pos: torch.Tensor, rows: int):
        """Text-only M-RoPE positions (p, p, p) [rows, 1, 3] at ``pos`` (a
        per-row [rows] or one shared position), as the reference's stage
        run builds them; None for RoPE."""
        if self.api.cfg.pos_type != "mrope":
            return None
        return pos.reshape(-1, 1, 1).expand(rows, 1, 3)

    def _stage_run(self, params, pools, s: int, x: torch.Tensor,
                   bt: torch.Tensor, sl: torch.Tensor) -> torch.Tensor:
        start, end = self._local(s)
        return self.api.model.decode_blocks(params, pools, x, bt, sl,
                                            start, end,
                                            pos3=self._pos3(sl, x.shape[0]))

    def _timeline_stage_run(self, params, body, s: int, x: torch.Tensor,
                            cache_len: torch.Tensor, start=None,
                            rows: slice = slice(None)) -> torch.Tensor:
        """Stage s's layers on the timeline rows ``rows``, carrying every
        layer's cache tree (a Hymba layer's rolling KV, conv window and SSM
        state, an xLSTM pair's recurrent state) in place."""
        lo, hi = self._local(s)
        return self.api.model.decode_timeline_blocks(
            params, body, x, cache_len, start, lo, hi, rows,
            pos3=self._pos3(cache_len, x.shape[0]))

    def build_stage_probe(self, paged: bool = True) -> Callable:
        """A single-stage runner for per-stage wall-time telemetry, which
        runs stage s's layer range on one microbatch exactly as a tick
        would (minus the seal) and returns its output. The caller times it
        (the engine: CUDA events on the card, the host clock on the CPU).
        The probe must leave the serving state as it found it.

        ``paged=True``: ``probe(params, pools, s, x, bt, sl)``; the caller
        passes block-table rows of the null page, so every K/V write is
        dropped and every read sees the zero page, over as many pages as
        the live lengths reach. ``paged=False`` (the timeline):
        ``probe(params, body, s, x, cache_len)``; the caller passes a
        scratch body of one microbatch's rows, so the writes land there
        and the attention covers the live horizon (its cost does not
        depend on what the cache holds)."""
        if paged:
            return self._stage_run
        return self._timeline_stage_run

    # -- the step -------------------------------------------------------------
    def build(self, paged: bool = True,
              per_slot_start: bool = True) -> Callable:
        """``step_fn(params, cache, batch, key) -> (logits, cache)``;
        ``batch["tokens"]`` is [B, 1]; ``key`` is the uint32 boundary key
        of this step, a one-element integer tensor on the device (the
        engine's, which a captured step reads at every replay) or an int
        (eager callers). Returns f32 logits [B, V] and the cache, updated
        in place.

        ``paged=True``: ``cache`` is the paged cache dict of
        ``ModelAPI.init_paged_cache`` (pools ``[L, N, KVH, Pg, D]``,
        ``block_tables`` [B, MP], ``seq_lens`` [B]). Demand paging / COW:
        the engine backs every row's next write position with a private
        page before the step, so the stages never write a shared page;
        reads gather freely across shared pages.

        ``paged=False``: ``cache`` is the staged timeline tuple
        ``(body, len, start)`` with ``start`` the per-slot [B] first valid
        positions (``per_slot_start``, the engine's continuous-batching
        mask), or ``(body, len)`` without it; ``len`` advances by one."""
        if self.mesh is not None:
            return self._rank_build(paged, per_slot_start)
        if not paged:
            return self._build_timeline(per_slot_start)
        stage_run = self._stage_run
        ticks = self._ticks()

        def step_fn(params, cache, batch, key):
            bt, sl = cache["block_tables"], cache["seq_lens"]
            pools = cache[self.api.model.served_segment.name]
            logits = ticks(params, batch["tokens"], key,
                           lambda s, x, rows: stage_run(
                               params, pools, s, x, bt[rows], sl[rows]))
            sl.copy_(torch.where(sl > 0, sl + 1, sl))
            return logits, cache

        return step_fn

    def _build_timeline(self, per_slot_start: bool) -> Callable:
        """``build(paged=False)``: the tick loop over the timeline cache.
        Microbatch m's rows of every stage's layers sit at the shared
        position ``len``; stage s runs its layer range on them and seals
        its boundary as on the paged layout."""
        stage_run = self._timeline_stage_run
        ticks = self._ticks()

        def step_fn(params, cache, batch, key):
            if per_slot_start:
                body, cache_len, start = cache
            else:
                (body, cache_len), start = cache, None

            def run(s, x, rows):
                st = None if start is None else start[rows]
                return stage_run(params, body, s, x, cache_len, st, rows)

            logits = ticks(params, batch["tokens"], key, run)
            cache_len.add_(1)
            return logits, cache

        return step_fn

    def boundary_counters(self, d: int, D: int) -> Optional[torch.Tensor]:
        """[S - 1, nm + S] int64 on the device: row s holds
        ``_leaf_counter(t, s * D + d)`` for every tick t, the counters
        stage s seals its boundary under on data rank d of D (tick t seals
        under t + 1). One leaf a (stage, data rank), so no two
        activations of a step share a (key, counter) pair at any stage
        count; at two stages only stage 0 seals, under leaf d, the
        reference's counters. Built once: a host-to-device copy cannot be
        captured in a CUDA graph."""
        S, nm = self.num_stages, self.num_microbatches
        if S < 2:
            return None
        return torch.stack([sealing.leaf_counters(
            nm + S, self.api.device, leaf=s * D + d) for s in range(S - 1)])

    def _ticks(self) -> Callable:
        """The tick loop of one step, for either layout:
        ``ticks(params, tokens, key, run) -> f32 logits [B, V]``, where
        ``run(s, x, rows)`` runs stage s on microbatch ``rows`` (a slice of
        the batch). Microbatch m leaves stage s at tick ``t = m + s``,
        sealed under ``key`` and the counter of tick t + 1 at leaf s
        (``boundary_counters``); stage 0 embeds, the last stage applies
        the head."""
        api, model = self.api, self.api.model
        S, nm = self.num_stages, self.num_microbatches
        seal_on = self.seal_boundary
        ctrs = self.boundary_counters(0, 1) if seal_on else None

        def ticks(params, tokens, key, run):
            B = tokens.shape[0]                            # tokens [B, 1]
            assert B % nm == 0, (B, nm)
            B_mb = B // nm
            d = api.cfg.d_model
            inflight: List[Any] = [None] * nm    # each microbatch's boundary
            logits = [None] * nm
            for t in range(nm + S - 1):
                for s in range(S):
                    m = t - s
                    if not 0 <= m < nm:
                        continue        # a warm-up / drain slot: nothing runs
                    rows = slice(m * B_mb, (m + 1) * B_mb)
                    if s == 0:
                        x = model.embed(params, tokens[rows])
                    elif seal_on:
                        cipher, scales = inflight[m]
                        x = K.unseal(cipher, scales, key,
                                     ctrs[s - 1, t:t + 1],
                                     out_dtype=api.dtype).reshape(B_mb, 1, d)
                    else:
                        x = inflight[m]
                    h = run(s, x, rows)
                    if s == S - 1:
                        logits[m] = model.head(params, h)
                    elif seal_on:
                        inflight[m] = K.seal(h.reshape(-1, d), key,
                                             ctrs[s, t + 1:t + 2])
                    else:
                        inflight[m] = h
            return torch.cat(logits)

        return ticks

    # -- the step on a rank: device segments between messages ----------------
    def _rank_build(self, paged: bool, per_slot_start: bool) -> Callable:
        """``build`` on a rank: ``rank_segments`` run eagerly by
        ``rank_loop``. A step whose data ranks split the rows needs
        ``batch["exchange"] = (key, n)``: the page-cipher key and the
        step's exchange number, to seal the KV entries exchanged after
        it."""
        segs = self.rank_segments(paged, per_slot_start)

        def step_fn(params, cache, batch, key):
            tokens = batch["tokens"]
            exchange = None
            if self.exchanges(tokens.shape[0]):
                if "exchange" not in batch:
                    raise ValueError(
                        "PipelinedDecoder(mesh=) over data ranks: the step's "
                        "batch needs 'exchange': (key, n), the page-cipher "
                        "key and the step's exchange number, to seal the KV "
                        "entries the data ranks of a pod exchange after it")
                ekey, n = batch["exchange"]
                exchange = (ekey, torch.tensor(self.exchange_counters(n),
                                               dtype=torch.int64,
                                               device=tokens.device))
            bound = {name: (lambda *a, f=f: f(params, cache, *a))
                     for name, f in segs.items()}
            with self.context():
                return self.rank_loop(bound, tokens, key, exchange), cache

        return step_fn

    def rank_segments(self, paged: bool = True, per_slot_start: bool = True
                      ) -> Dict[str, Callable]:
        """This rank's decode step as segments that touch the device only,
        each ``f(params, cache, *args)`` over the paged cache dict or the
        timeline's staged tuple ``(body, len[, start])``:

        * ``tick(m, B, tokens, got, key)``: microbatch m of a step of B
          rows on this stage (this rank's block of its rows, ``splits``):
          stage 0 embeds ``tokens`` [B, 1], a later stage opens ``got``
          (the cipher and scales received, or the raw hidden state) under
          ``key`` and the counter of tick ``m + s`` at leaf ``(s - 1) *
          data + d``; then the stage's layers, and the head on the last
          stage ([b, V] f32 logits), else the hidden state sealed under
          the counter of tick ``m + s + 1`` at leaf ``s * data + d``
          (``boundary_counters``) or raw. Over a model axis model rank 0
          opens ``got`` and broadcasts it over its model group (the
          others take None), and seals alone (the others return None):
          the activation leaving a stage is whole on every model rank;
        * ``take(B, key, ctr)``: the KV entries this data rank wrote in
          the step (``rank_loop``), packed into one float [n, cols] and
          sealed under ``key`` and ``ctr[d]`` (raw with ``seal_boundary``
          off);
        * ``tail(B, key, ctr, got)``: each peer's entries ``got`` (in data
          order, without this rank's) opened under its ``ctr[i]`` and
          written, then ``seq_lens`` (paged) or ``len`` advanced; with no
          exchange ``key`` and ``ctr`` are None and ``got`` empty."""
        api, model = self.api, self.api.model
        S, nm, s = self.num_stages, self.num_microbatches, self.stage
        D, d = self.num_data, self.data
        seal_on = self.seal_boundary
        ctrs = self.boundary_counters(d, D) if seal_on else None
        dm = api.cfg.d_model
        run, take_rows, put_rows, advance = (
            self._paged_parts() if paged
            else self._timeline_parts(per_slot_start))

        def tick(params, cache, m, B, tokens, got, key):
            b, lo = self._block(B)
            B_mb, t = B // nm, m + s               # t: the reference's tick
            rows = slice(m * B_mb + lo, m * B_mb + lo + b)
            if s == 0:
                x = model.embed(params, tokens[rows])
            else:
                x = None
                if got is None:
                    pass                # a model rank other than 0
                elif seal_on:
                    x = K.unseal(got[0], got[1], key, ctrs[s - 1, t:t + 1],
                                 out_dtype=api.dtype)
                else:
                    x = got[0]
                x = TP.from_lead(x, (b, 1, dm), api.dtype,
                                 api.device).reshape(b, 1, dm)
            h = run(params, cache, s, x, rows)
            if s == S - 1:
                return model.head(params, h)
            if not self.lead:
                return None
            if seal_on:
                return K.seal(h.reshape(-1, dm), key, ctrs[s, t + 1:t + 2])
            return (h,)

        def take(params, cache, B, key, ctr):
            mine = _pack_rows(take_rows(cache, self._rows_of(d, B)))
            return K.seal_bits(mine, key, ctr[d:d + 1]) if seal_on else mine

        def tail(params, cache, B, key, ctr, got):
            peers = [i for i in range(D) if i != d]
            for i, c in zip(peers, got):
                rows = self._rows_of(i, B)
                likes = take_rows(cache, rows)
                if seal_on:
                    c = K.unseal_bits(c, key, ctr[i:i + 1],
                                      out_dtype=_packed_dtype(likes))
                put_rows(cache, rows, _unpack_rows(c, likes))
            advance(cache)

        return {"tick": tick, "take": take, "tail": tail}

    def _paged_parts(self):
        """(run, take, put, advance) of ``rank_segments`` over the paged
        cache: each row's K and V at the (page, offset) its decode writes
        (``layers.paged_write_targets`` at the step's seq_lens; a dropped
        row reads and writes the null page's zeros), over this stage's
        layers."""
        seg = self.api.model.served_segment.name

        def run(params, cache, s, x, rows):
            return self._stage_run(params, cache[seg], s, x,
                                   cache["block_tables"][rows],
                                   cache["seq_lens"][rows])

        def targets(cache, rows):
            return paged_write_targets(cache["block_tables"][rows],
                                       cache["seq_lens"][rows],
                                       cache[seg][0].shape[3])[:2]

        def take(cache, rows):
            page, off = targets(cache, rows)
            return [pool[:, page, :, off] for pool in cache[seg]]

        def put(cache, rows, parts):
            page, off = targets(cache, rows)
            for pool, g in zip(cache[seg], parts):
                pool[:, page, :, off] = g

        def advance(cache):
            sl = cache["seq_lens"]
            sl.copy_(torch.where(sl > 0, sl + 1, sl))

        return run, take, put, advance

    def _timeline_parts(self, per_slot_start: bool):
        """(run, take, put, advance) of ``rank_segments`` over the timeline
        body: each leaf with a batch axis, at the slot the step wrote on a
        leaf with a KV time axis (``decode_slot``, a device index: no host
        read), whole rows of a recurrent state; a leaf without a batch
        axis (the int8 cache's scales) is written by prefill only and
        stays."""
        segment = self.api.model.served_segment
        axes = axes_leaves(self.api.model.init_cache_axes()[segment.name])

        def parts(cache):
            body, cache_len = cache[0], cache[1]
            flat = leaves(body)
            assert len(axes) == len(flat), (len(axes), len(flat))
            slot = segment.block.decode_slot(cache_len, body)
            out = []
            for t, ax in zip(flat, axes):
                if "act_kv_batch" not in ax:
                    continue
                sd = ax.index("act_kv_seq") if "act_kv_seq" in ax else None
                # a block of the positions: the slot's index there, or the
                # block's edge, whose entries the data ranks already share
                at = slot if sd is None else \
                    TP.local_slot(slot, t.shape[sd])[0]
                out.append((t, ax.index("act_kv_batch"), sd, at))
            return out

        def run(params, cache, s, x, rows):
            start = cache[2][rows] if per_slot_start else None
            return self._timeline_stage_run(params, cache[0], s, x, cache[1],
                                            start, rows)

        def take(cache, rows):
            out = []
            for t, bd, sd, slot in parts(cache):
                if sd is not None:
                    t = t.index_select(sd, slot)
                out.append(t.index_select(bd, rows).movedim(bd, 0))
            return out

        def put(cache, rows, got):
            for (t, bd, sd, slot), g in zip(parts(cache), got):
                if sd is None:
                    t.index_copy_(bd, rows, g.movedim(0, bd))
                    continue
                at = t.index_select(sd, slot)
                at.index_copy_(bd, rows, g.movedim(0, bd))
                t.index_copy_(sd, slot, at)

        def advance(cache):
            cache[1].add_(1)

        return run, take, put, advance

    def exchanges(self, B: int) -> bool:
        """Whether a step of ``B`` rows ends with a KV exchange between the
        data ranks of a pod: they split its microbatches."""
        return self.mesh is not None and self.splits(
            B // self.num_microbatches)

    def exchange_counters(self, n: int) -> List[int]:
        """The page-cipher counters of the n-th KV exchange of this stage's
        data ranks of this model index, one a data rank: data rank i of
        model index m seals its entries under the exchange sequence
        number ``((n * pods + s) * data + i) * model + m``
        (``sealing.exchange_seq``; ``(n * pods + s) * data + i`` with one
        model rank): the model ranks exchange their own KV heads."""
        first = (n * self.num_stages + self.stage) * self.num_data
        return [sealing._swap_counter(sealing.exchange_seq(
            (first + i) * self.num_model + self.model, self.prefill_role), 0)
            for i in range(self.num_data)]

    def rank_loop(self, segs: Dict[str, Callable], tokens: torch.Tensor,
                  key, exchange=None) -> torch.Tensor:
        """One decode step of this rank: ``segs`` (``rank_segments``'
        segments, called with their per-call arguments) in tick order,
        with the messages between them posted here: stage s takes its
        microbatches in order, receives each from the previous stage's
        rank of its data index and posts its output to the next one's;
        then the last stage's logits reach every rank (a broadcast over
        ``pod``, then a gather over ``data``), and, where the data ranks
        split the rows, the KV exchange (``exchange``: the page-cipher key
        and the ``exchange_counters``, device tensors) runs between
        ``take`` and ``tail``: after the step the data ranks of a pod hold
        one cache (the reference's replicated pools). Returns the f32
        logits [B, V]. Keeps the host ms spent in segments (each between
        two device synchronises) and in messages in ``last_split``, and
        the exchange's (host ms, bytes sent) in ``last_exchange``."""
        api = self.api
        S, nm, s = self.num_stages, self.num_microbatches, self.stage
        V, dm = api.cfg.vocab_size, api.cfg.d_model
        B = tokens.shape[0]                                # tokens [B, 1]
        assert B % nm == 0, (B, nm)
        b, _ = self._block(B)
        dev = tokens.device
        clock = _Clock(dev)
        staging, pod_g = self.staging, self._pod_group
        # over a model axis, model rank 0 of a stage holds its crossings
        prev = self._pod_ranks[s - 1] if s > 0 and self.lead else None
        nxt = self._pod_ranks[s + 1] if s < S - 1 and self.lead else None
        if self.seal_boundary:
            likes = (torch.empty((b, dm), dtype=torch.uint8, device=dev),
                     torch.empty((b, 1), dtype=torch.float32, device=dev))
        else:
            likes = (torch.empty((b, 1, dm), dtype=api.dtype, device=dev),)
        logits = torch.empty((nm, b, V), dtype=torch.float32, device=dev)
        posted = []
        for m in range(nm):
            got = None
            if prev is not None:
                got = tuple(clock.message(lambda: RK.recv(
                    staging, likes, prev, pod_g, tag="in").wait()))
            out = clock.segment(segs["tick"], m, B,
                                tokens if s == 0 else None, got, key)
            if s == S - 1:
                logits[m].copy_(out)
            elif nxt is not None:
                posted.append(clock.message(lambda: RK.send(
                    staging, out, nxt, pod_g, tag=("out", m))))
        clock.message(lambda: [p.wait() for p in posted])
        clock.message(lambda: RK.broadcast(staging, logits,
                                           self._pod_ranks[-1], pod_g,
                                           tag="logits"))
        if self.splits(B // nm):
            every = clock.message(lambda: RK.all_gather(
                staging, logits, self._data_group, tag="logits"))
            # every: [D, nm, b, V]; row m * B_mb + d * b + j is [d, m, j]
            logits = every.transpose(0, 1).reshape(B, V)
        else:
            logits = logits.reshape(B, V)
        if exchange is None:
            clock.segment(segs["tail"], B, None, None, ())
        else:
            self._exchange(segs, B, exchange, clock)
        self.last_split = (clock.segment_ms, clock.message_ms)
        return logits

    def _exchange(self, segs, B: int, exchange, clock: "_Clock") -> None:
        """The KV exchange of ``rank_loop``: ``take`` seals this rank's
        entries, every peer of the pod's data ranks gets them and ``tail``
        writes theirs. Keeps (host ms, bytes sent) in ``last_exchange``."""
        key, ctr = exchange
        D, d = self.num_data, self.data
        staging = self.exchange_staging
        self._sync()
        t0, sent0 = time.perf_counter(), staging.sent
        payload = clock.segment(segs["take"], B, key, ctr)
        peers = [i for i in range(D) if i != d]
        got = clock.message(lambda: RK.transfer(
            staging, [(self._data_ranks[i], [payload]) for i in peers],
            [(self._data_ranks[i], [torch.empty_like(payload)])
             for i in peers], self._data_group, tag="exchange"))
        clock.segment(segs["tail"], B, key, ctr, tuple(c for (c,) in got))
        self._sync()
        self.last_exchange = ((time.perf_counter() - t0) * 1e3,
                              staging.sent - sent0)


class _Clock:
    """Host ms a rank step spends in its device segments (each timed
    between two synchronises of the device, so a segment's time is its
    launches or replay and its device work) and in its messages."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.dev = dev
        self.segment_ms = self.message_ms = 0.0

    def segment(self, f: Callable, *args):
        if self.cuda:
            torch.cuda.synchronize(self.dev)
        t0 = time.perf_counter()
        out = f(*args)
        if self.cuda:
            torch.cuda.synchronize(self.dev)
        self.segment_ms += (time.perf_counter() - t0) * 1e3
        return out

    def message(self, post: Callable):
        t0 = time.perf_counter()
        out = post()
        self.message_ms += (time.perf_counter() - t0) * 1e3
        return out


def axes_leaves(axes) -> List[tuple]:
    """The leaves of a cache's axes tree (a tuple of axis names each), in
    ``tree.leaves`` order."""
    if isinstance(axes, tuple) and all(a is None or isinstance(a, str)
                                       for a in axes):
        return [axes]
    if isinstance(axes, dict):
        return [x for k in sorted(axes) for x in axes_leaves(axes[k])]
    return [x for a in axes for x in axes_leaves(a)]


def _packed_dtype(parts: Sequence[torch.Tensor]) -> torch.dtype:
    """The float type ``_pack_rows`` packs ``parts`` in."""
    dt = parts[0].dtype
    if dt in (torch.float32, torch.bfloat16) and all(p.dtype == dt
                                                     for p in parts):
        return dt
    return torch.bfloat16


def _pack_rows(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Tensors [n, ...] side by side as one float [n, cols] the page
    cipher moves: in their own type when they share f32 or bf16, else
    their bytes as bf16."""
    flat = [p.reshape(p.shape[0], -1) for p in parts]
    dt = flat[0].dtype
    if dt in (torch.float32, torch.bfloat16) and all(f.dtype == dt
                                                     for f in flat):
        return torch.cat(flat, 1)
    raw = torch.cat([f.contiguous().view(torch.uint8) for f in flat], 1)
    assert raw.shape[1] % 2 == 0, raw.shape
    return raw.view(torch.bfloat16)


def _unpack_rows(packed: torch.Tensor, likes: Sequence[torch.Tensor]
                 ) -> List[torch.Tensor]:
    """The inverse of ``_pack_rows``: tensors shaped and typed as
    ``likes``."""
    n = packed.shape[0]
    if packed.dtype == likes[0].dtype and all(
            t.dtype == packed.dtype for t in likes):
        sizes = [t[0].numel() for t in likes]
        return [p.reshape(t.shape) for p, t in
                zip(packed.split(sizes, 1), likes)]
    raw = packed.contiguous().view(torch.uint8)
    sizes = [t[0].numel() * t.element_size() for t in likes]
    return [p.contiguous().view(t.dtype).reshape(t.shape)
            for p, t in zip(raw.split(sizes, 1), likes)]
