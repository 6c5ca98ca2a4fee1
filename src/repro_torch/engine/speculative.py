"""Speculative decoding for the in-flight decoder (port of
``repro/engine/speculative.py``): Context-stream drafts, paged multi-token
verification.

A small draft model proposes k answer tokens per row autoregressively; the
serving model scores every row's chunk (its last accepted token plus the
drafts) in one paged multi-token pass (``vlm.llm_verify_step_paged``).
Under greedy decoding a draft token is accepted iff it equals the serving
model's own greedy pick at that position, so the emitted stream is
token-exact with ``llm_generate``: acceptance changes how many serving
passes an answer costs, never its content.

The draft model rides a per-slot contiguous ring cache and needs no
rollback: a rejected draft's k/v sits at a position ahead of the committed
stream, the position mask hides it, and the real token overwrites the
slot when it is fed. The paged serving cache does roll back
(``PagePool.rollback_to``). ``SpecStats.acceptance_rate`` is the signal a
control policy gates drafting on (``InflightDecoder(spec_gate=...)``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import DeviceLike, bridge, resolve_device
from repro_torch.core import vlm

_ROADMAP = "is not ported yet; see ROADMAP.md, Queue 1"


@dataclass(frozen=True)
class SpeculativeConfig:
    """Knobs of the speculative-decoding subsystem."""
    draft_tokens: int = 3          # k: drafts proposed per verify round
    # drafting disables when cumulative acceptance falls below the floor
    # (after min_draft_samples drafted tokens): the policy hook applies these
    acceptance_floor: float = 0.35
    min_draft_samples: int = 16
    # draft model override: defaults to the serving model's own LLM (shared
    # weights, so drafts never diverge); plug a distinct small LM via these
    draft_params: Optional[dict] = None
    draft_pcfg: Optional[Any] = None

    def __post_init__(self):
        if self.draft_tokens < 1:
            raise ValueError(
                f"draft_tokens must be >= 1, got {self.draft_tokens}")


@dataclass
class SpecStats:
    """Cumulative speculation telemetry of one decoder."""
    drafted: int = 0            # draft tokens submitted to verification
    accepted: int = 0           # draft tokens the serving model agreed with
    emitted: int = 0            # tokens emitted by drafting rows
    row_steps: int = 0          # (row, verify-step) pairs that drafted
    disabled_steps: int = 0     # steps the policy vetoed drafting on
    pages_rolled_back: int = 0  # KV pages freed by speculative rollback

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0

    @property
    def tokens_per_step(self) -> float:
        """Mean tokens emitted per drafting row per verify step: 1.0 is the
        plain-decode floor, k+1 the full-acceptance ceiling."""
        return self.emitted / self.row_steps if self.row_steps else 0.0

    def note_chunk(self, drafted: int, accepted: int, emitted: int,
                   metrics: Optional[Any] = None) -> None:
        """Fold one drafting row's verify-chunk outcome in; with a
        ``MetricsRegistry`` attached the chunk's acceptance fraction also
        feeds the ``spec_accept_rate`` histogram."""
        self.drafted += drafted
        self.accepted += accepted
        self.emitted += emitted
        self.row_steps += 1
        if metrics is not None and drafted:
            metrics.histogram("spec_accept_rate").observe(
                accepted / drafted)

    def merge(self, other: "SpecStats") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))

    def as_dict(self) -> Dict[str, float]:
        return {
            "spec_drafted": self.drafted,
            "spec_accepted": self.accepted,
            "spec_acceptance_rate": self.acceptance_rate,
            "spec_tokens_per_step": self.tokens_per_step,
            "spec_disabled_steps": self.disabled_steps,
            "spec_pages_rolled_back": self.pages_rolled_back,
        }


def greedy_accept(drafts: Sequence[int], greedy: Sequence[int]) -> int:
    """Number of leading draft tokens that equal the serving model's own
    greedy continuation (``greedy[i]`` is the argmax after chunk token i,
    so draft i+1 is accepted iff it equals ``greedy[i]``)."""
    m = 0
    while m < len(drafts) and int(drafts[m]) == int(greedy[m]):
        m += 1
    return m


class DraftModel:
    """The draft model, batched over the in-flight slots.

    ``admit`` prefills a slot's ``[ctx; query]`` prefix into its row of a
    ``(slots, width)`` ring cache; ``draft`` runs lockstep batched
    single-token steps (per-row positions, ``vlm.llm_decode_step``, the
    contiguous flash-decode kernel when ``flash_decode`` is set) that catch
    up on newly committed tokens and then self-feed k proposals. The cache
    is made lazily from the first prefilled row and updated IN PLACE (the
    reference rebuilds it). Idle rows park their step on the last ring
    slot (``width - 1``), which no real position maps to.
    """

    def __init__(self, params: dict, pcfg: Any, *, slots: int,
                 prefix_len: int, max_new_tokens: int, draft_tokens: int,
                 flash_decode: bool = False,
                 prefix_rows: Optional[Dict[Any, Dict]] = None,
                 prefix_cap: Optional[int] = None,
                 fns_factory: Optional[Any] = None,
                 device: DeviceLike = None):
        if fns_factory is not None:
            raise NotImplementedError(
                f"sharded draft stages (fns_factory) {_ROADMAP}")
        self.device = resolve_device(device)
        self.pcfg = dataclasses.replace(
            pcfg, llm=pcfg.llm.replace(use_flash_decode=flash_decode))
        # tensors already on the device are shared, not copied
        self.params = bridge.to_torch(params, self.device)
        self.slots = int(slots)
        self.prefix_len = int(prefix_len)
        # widest real position: catching up tokens[:T] then self-feeding
        # k-1 drafts reaches prefix + T + k - 2; slot width-1 is the park
        self.width = self.prefix_len + int(max_new_tokens) \
            + int(draft_tokens)
        self.park_pos = self.width - 1
        self.cache: Optional[Dict] = None
        # emitted (serving-model-committed) tokens each row has consumed
        self.fed = np.zeros((self.slots,), np.int64)
        self.n_steps = 0           # batched draft decode steps
        self.n_prefills = 0
        # prefilled [ctx; query] rows keyed like the serving prefix store,
        # so repeat-prefix admissions skip the draft prefill too (LRU-capped;
        # the dict may be shared across decoders). Keys carry the ring
        # width, so decoders of other query lengths never share a row.
        self._prefix_rows: Dict[Any, Dict] = (
            prefix_rows if prefix_rows is not None else {})
        self._prefix_cap = (prefix_cap if prefix_cap is not None
                            else 2 * self.slots)

    @staticmethod
    def _insert_row(dst: Dict, src: Dict, row: int) -> Dict:
        """Copy a 1-row prefill cache into row ``row`` of the slot cache,
        IN PLACE: kv leaves (L, B, W, ...) at axis 1, positions (B, W)."""
        for d, s in zip(dst["groups"], src["groups"]):
            for name in d:
                d[name][:, row] = s[name][:, 0]
        dst["positions"][row] = src["positions"][0]
        return dst

    @torch.inference_mode()
    def admit(self, row: int, ctx, query, key: Any = None) -> None:
        """Prefill one slot's ``[ctx; query]`` prefix into its cache row.
        ``key`` (the serving prefix store's key) lets repeat-prefix
        admissions reuse a stored prefill row instead of re-running the
        draft prefill."""
        skey = (key, self.width) if key is not None else None
        row_cache = self._prefix_rows.get(skey) if skey is not None else None
        if row_cache is None:
            ctx = torch.as_tensor(np.asarray(ctx)).to(self.device)
            if ctx.shape[-1] != self.pcfg.llm.d_model:
                raise ValueError(
                    f"draft model width {self.pcfg.llm.d_model} does not "
                    f"match context features {ctx.shape[-1]}")
            query = torch.as_tensor(np.asarray(query)).to(self.device)
            _, _, row_cache = vlm.llm_prefill(self.params, self.pcfg, ctx,
                                              query, width=self.width)
            self.n_prefills += 1
            if skey is not None:
                self._prefix_rows[skey] = row_cache
                while len(self._prefix_rows) > self._prefix_cap:
                    self._prefix_rows.pop(next(iter(self._prefix_rows)))
        else:                          # refresh recency
            self._prefix_rows[skey] = self._prefix_rows.pop(skey)
        if self.cache is None:
            self.cache = {
                "groups": [{name: a.new_zeros((a.shape[0], self.slots)
                                              + a.shape[2:])
                            for name, a in g.items()}
                           for g in row_cache["groups"]],
                "positions": torch.full((self.slots, self.width), -1,
                                        dtype=torch.int32,
                                        device=self.device),
            }
        self._insert_row(self.cache, row_cache, row)
        self.fed[row] = 0

    def release(self, row: int) -> None:
        self.fed[row] = 0          # admit() re-prefills the row wholesale

    def commit(self, row: int, n_fed: int) -> None:
        """Mark emitted tokens up to ``n_fed`` as consumed: an accepted
        draft's k/v already sits in this cache at the position the
        committed token occupies. Only moves forward; the rejected tail is
        left to the position mask."""
        self.fed[row] = max(self.fed[row], n_fed)

    @torch.inference_mode()
    def draft(self, jobs: Dict[int, List[int]], k: int,
              budgets: Optional[Dict[int, int]] = None
              ) -> Dict[int, List[int]]:
        """One drafting round: for each row in ``jobs`` (row -> emitted
        tokens), feed the emitted tokens it has not consumed yet, then
        self-feed until the row's proposal budget (``budgets[row]``,
        default k) is collected. All rows advance in lockstep batched
        decode steps; rows that are done (or not drafting) park on the
        reserved slot. Returns row -> proposed tokens."""
        if not jobs:
            return {}
        want = {r: min(k, (budgets or {}).get(r, k)) for r in jobs}
        queue = {r: list(toks[int(self.fed[r]):]) for r, toks in
                 jobs.items()}
        for r, pend in queue.items():
            assert pend, f"row {r} has no unfed committed token"
        pos_next = {r: self.prefix_len + int(self.fed[r]) for r in jobs}
        drafts: Dict[int, List[int]] = {r: [] for r in jobs}
        while any(len(drafts[r]) < want[r] for r in jobs):
            toks = np.zeros((self.slots, 1), np.int32)
            pos = np.full((self.slots,), self.park_pos, np.int32)
            feeding = []
            for r in jobs:
                if len(drafts[r]) >= want[r]:
                    continue
                t = queue[r].pop(0) if queue[r] else drafts[r][-1]
                toks[r, 0] = t
                pos[r] = pos_next[r]
                pos_next[r] += 1
                feeding.append(r)
            logits, _, self.cache = vlm.llm_decode_step(
                self.params, self.pcfg, self.cache,
                torch.from_numpy(toks).to(self.device),
                torch.from_numpy(pos).to(self.device))
            logits = logits.float().cpu().numpy()
            self.n_steps += 1
            for r in feeding:
                if not queue[r]:       # fed the stream tail or a draft
                    drafts[r].append(int(np.argmax(logits[r])))
        for r, toks_ in jobs.items():
            self.fed[r] = len(toks_)
        return drafts
