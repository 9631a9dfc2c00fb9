"""Self-speculative drafting for the packed serving stream.

``NGramDrafter`` is a deterministic prompt-lookup / n-gram drafter
(no second model): per slot it maintains the token history — prompt +
every *accepted* output token — and a suffix-keyed table mapping each
n-gram (n in ``[ngram_min, ngram_max]``) to the position right after its
two most recent occurrences.  ``propose(slot, k)`` matches the longest
suffix of the current history against the table and copies up to ``k``
tokens that followed the previous occurrence.  Pure host-side data
structure: no RNG, no device work — identical inputs always produce
identical drafts, which is what makes the engine's acceptance rule
token-identity-preserving end to end.

The engine verifies drafts with greedy acceptance: a drafted token is
kept iff it equals the model's own argmax at that position, so the
drafter is purely a *performance* hint — a bad draft costs verify lanes,
never correctness.

``markov_params`` crafts model weights whose greedy decode follows an
explicit token->token map (blocks zeroed out, the head wired to the
normalized embedding rows).  Benchmarks and tests use it to build
acceptance *regimes* on demand — fully-predictable (repetitive /
code-like) and adversarial (drafts always rejected) workloads — through
the real engine, kernels, and acceptance rule.

The drafter is the reference's code; ``markov_params`` is its
construction on torch parameter trees.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["NGramDrafter", "markov_params"]


class _SlotHistory:
    """Token history + suffix-keyed n-gram table for one slot."""

    __slots__ = ("toks", "table")

    def __init__(self, ngram_min: int, ngram_max: int) -> None:
        self.toks: list[int] = []
        # per n: key (n-gram tuple) -> (latest end-position, previous one).
        # The entry for the *current* tail always holds the tail itself in
        # slot 0, so ``propose`` reads the previous occurrence from slot 1.
        self.table: dict[int, dict[tuple, tuple[int, int | None]]] = {
            n: {} for n in range(ngram_min, ngram_max + 1)}

    def append(self, tok: int) -> None:
        self.toks.append(tok)
        end = len(self.toks)
        for n, tab in self.table.items():
            if end < n:
                continue
            key = tuple(self.toks[end - n:end])
            old = tab.get(key)
            tab[key] = (end, old[0] if old is not None else None)


class NGramDrafter:
    """Deterministic suffix-match drafter over prompt + accepted output."""

    def __init__(self, ngram_max: int = 3, ngram_min: int = 1) -> None:
        if not 1 <= ngram_min <= ngram_max:
            raise ValueError(f"bad n-gram range [{ngram_min}, {ngram_max}]")
        self.ngram_min = int(ngram_min)
        self.ngram_max = int(ngram_max)
        self._slots: dict[int, _SlotHistory] = {}

    # -- lifecycle (engine slot protocol) ---------------------------------

    def begin(self, slot: int, req) -> None:
        """(Re)seed a slot's history from a request's prompt."""
        h = _SlotHistory(self.ngram_min, self.ngram_max)
        for t in np.asarray(req.prompt).tolist():
            h.append(int(t))
        self._slots[slot] = h

    def extend(self, slot: int, toks) -> None:
        """Record newly *accepted* (emitted) tokens for a slot."""
        h = self._slots.get(slot)
        if h is None:
            return
        for t in np.asarray(toks).tolist():
            h.append(int(t))

    def drop(self, slot: int) -> None:
        """Forget a slot (finish, preemption, requeue)."""
        self._slots.pop(slot, None)

    # -- drafting ----------------------------------------------------------

    def propose(self, slot: int, k: int) -> np.ndarray:
        """Up to ``k`` draft tokens continuing the slot's history.

        Longest-suffix match wins; within one n the most recent previous
        occurrence wins.  Returns an empty array when no suffix of the
        history has occurred before.
        """
        h = self._slots.get(slot)
        if h is None or k <= 0:
            return np.zeros(0, np.int32)
        end = len(h.toks)
        for n in range(self.ngram_max, self.ngram_min - 1, -1):
            if end < n:
                continue
            hit = h.table[n].get(tuple(h.toks[end - n:end]))
            if hit is None:
                continue
            # slot 0 is the tail itself (registered on append); the draft
            # source is the *previous* occurrence
            src = hit[1] if hit[0] == end else hit[0]
            if src is None or src >= end:
                continue
            d = min(k, end - src)
            return np.asarray(h.toks[src:src + d], np.int32)
        return np.zeros(0, np.int32)


# --------------------------------------------------------------------------
# crafted-weight fixture: a model whose greedy decode IS a token map
# --------------------------------------------------------------------------

def _zero_blocks(tree):
    """A copy of a parameter tree with every ``wo`` and ``w_down`` leaf
    zeroed (the other leaves shared, not copied)."""
    if isinstance(tree, dict):
        return {k: (torch.zeros_like(v) if k in ("wo", "w_down")
                    and isinstance(v, torch.Tensor) else _zero_blocks(v))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zero_blocks(v) for v in tree)
    return tree


def markov_params(cfg, params: dict, mapping: dict[int, int]) -> dict:
    """Craft ``params`` so greedy decode emits ``mapping[last_token]``.

    Every residual-block contribution is zeroed (attention ``wo`` and MLP
    ``w_down``), so the final hidden state of a position is exactly the
    normalized embedding of its token; the (untied) head is then wired so
    ``argmax(logits(t)) == mapping[t]`` for every token in the map.  The
    result runs through the real forward pass and kernels — only the
    *content* of the weights is synthetic.  Requires a dense
    attention+MLP arch with ``tie_embeddings=False``; raises if any
    mapped token's argmax cannot be verified.  The head is f32, as the
    reference's, on the embedding's device (the model promotes the
    product to f32, as JAX does)."""
    from repro_torch.models import layers

    if cfg.tie_embeddings:
        raise ValueError("markov_params needs an untied head")

    out = _zero_blocks(params)
    emb = out["embed"]
    v, d = emb.shape
    # only the mapped tokens' rows enter: the reference's full [V, V]
    # check matrix is 16 GB at a 64k vocabulary, and its rows for the
    # mapped tokens are these
    keys = list(mapping)
    rows = torch.tensor(keys, dtype=torch.long, device=emb.device)
    en = layers.apply_norm(cfg.norm, {"scale": out["ln_f"]["scale"]},
                           emb[rows]).float().cpu().numpy()
    row = {t: i for i, t in enumerate(keys)}
    cols: dict[int, np.ndarray] = {}
    for t, j in mapping.items():
        e = en[row[t]]
        cols[j] = cols.get(j, np.zeros(d, np.float32)) + e / float(e @ e)
    js = list(cols)
    logits = np.zeros((len(keys), v), np.float32)
    logits[:, js] = en @ np.stack([cols[j] for j in js], axis=1)
    bad = [t for t, j in mapping.items()
           if int(np.argmax(logits[row[t]])) != j]
    if bad:
        raise ValueError(f"embedding cross-talk broke the map at {bad}")
    head = torch.zeros((d, v), dtype=torch.float32, device=emb.device)
    head[:, js] = torch.from_numpy(np.stack([cols[j] for j in js],
                                            axis=1)).to(emb.device)
    out["head"] = head
    return out
