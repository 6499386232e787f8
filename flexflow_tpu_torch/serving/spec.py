"""Speculative decoding (SpecInfer, Miao et al., ASPLOS 2024) — port of
flexflow_tpu/serving/spec.py. Plain numpy on the host, as in the
reference.

Decode reads every weight for one token of progress. Speculative
decoding buys more tokens per weight read: a cheap draft proposes k
continuation tokens, the target model scores all k+1 positions in one
verify call (`GenerationEngine.verify`, or `verify_tree` for a branching
draft), and an acceptance rule keeps the longest prefix the target
agrees with plus one token from the target itself. Greedy acceptance is
exact-match, so greedy speculative decode is token-for-token the plain
greedy stream: the draft changes when tokens arrive, never which.

The draft source here is `NGramDraftProposer` (weight-free prompt
lookup). The reference's small-model draft (`ModelDraftProposer`) is not
ported yet: `ServeConfig(spec_draft="model")` raises and names the
ROADMAP item.

Rollback is the cache-side half: verify writes K/V rows for all its
rows, then `cache.truncate(slot, new_len, src_rows)` commits the
accepted path (compacting a tree's accepted rows into contiguous
positions) and returns pages past it to the pool.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# -- acceptance --------------------------------------------------------------


def _rng(seed: int, slot: int, pos: int, sub: int) -> np.random.Generator:
    """Deterministic per-(seed, slot, position, draw) stream, so rejection
    sampling is reproducible and independent of batch composition."""
    return np.random.default_rng([seed & 0x7FFFFFFF, slot, pos, sub])


def _softmax(row: np.ndarray) -> np.ndarray:
    row = row.astype(np.float64)
    row = row - row.max()
    e = np.exp(row)
    return e / e.sum()


def accept_drafts(
    row_logits: np.ndarray,
    drafts: Sequence[int],
    temperature: float = 0.0,
    seed: int = 0,
    slot: int = 0,
    base_len: int = 0,
) -> Tuple[int, List[int]]:
    """Acceptance rule for one slot's verify output. row_logits
    [w >= len(drafts)+1, vocab] — row j is the target's distribution for
    the token following verify input j (input 0 is the last emitted
    token, inputs 1.. are the drafts). Returns (accepted, emitted):
    `accepted` drafts survive and `emitted` is drafts[:accepted] plus ONE
    token from the target itself (the correction at the first rejection,
    or the bonus after a full accept).

    temperature 0: greedy exact-match (argmax). temperature > 0:
    rejection sampling against the point-mass proposal (accept d with
    probability p(d); on rejection resample from p with d zeroed), the
    Leviathan/Chen rule. base_len is the cache position of the last
    emitted token; it seeds the per-position RNG streams."""
    k = len(drafts)
    if temperature <= 0.0:
        preds = np.argmax(row_logits[: k + 1], axis=-1)
        accepted = 0
        while accepted < k and int(drafts[accepted]) == int(preds[accepted]):
            accepted += 1
        return accepted, [int(t) for t in drafts[:accepted]] + [
            int(preds[accepted])
        ]
    emitted: List[int] = []
    for i in range(k):
        p = _softmax(row_logits[i] / temperature)
        d = int(drafts[i])
        # position the decided token will occupy: base_len + 1 + i
        u = _rng(seed, slot, base_len + 1 + i, 0).random()
        if u <= p[d]:
            emitted.append(d)
            continue
        residual = p.copy()
        residual[d] = 0.0
        total = residual.sum()
        if total <= 0.0:  # p was a delta at d — accept after all
            emitted.append(d)
            continue
        t = int(
            _rng(seed, slot, base_len + 1 + i, 1).choice(
                residual.size, p=residual / total
            )
        )
        emitted.append(t)
        return i, emitted
    p = _softmax(row_logits[k] / temperature)
    t = int(_rng(seed, slot, base_len + 1 + k, 0).choice(p.size, p=p))
    emitted.append(t)
    return k, emitted


# -- token trees (SpecInfer tree-verify) --------------------------------------


@dataclasses.dataclass
class DraftTree:
    """One slot's branching draft: a token tree rooted at the LAST
    EMITTED token (the root is implicit — it is verify row 0 and never
    appears in the node lists). tokens[i] is node i's token; parents[i]
    is its parent NODE index, -1 for children of the root. Nodes are
    topologically ordered (every parent index < its child's index); the
    verify mask, the acceptance walk and the truncate compaction rely on
    it. Node i occupies verify row 1 + i and cache position
    lengths[slot] + 1 + i during the verify."""

    tokens: List[int]
    parents: List[int]

    def __post_init__(self):
        if len(self.tokens) != len(self.parents):
            raise ValueError("tokens and parents must have equal length")
        for i, p in enumerate(self.parents):
            if not -1 <= p < i:
                raise ValueError(
                    f"node {i}: parent {p} breaks topological order"
                )

    @classmethod
    def from_chains(cls, chains: Sequence[Sequence[int]]) -> "DraftTree":
        """Trie-merge candidate chains, deduping shared prefixes: two
        chains agreeing on their first j tokens share j nodes and branch
        at the divergence. Chain order is deterministic (the first
        chain's nodes come first)."""
        tokens: List[int] = []
        parents: List[int] = []
        kids: Dict[int, Dict[int, int]] = {}
        for chain in chains:
            cur = -1
            for t in chain:
                t = int(t)
                node = kids.setdefault(cur, {}).get(t)
                if node is None:
                    node = len(tokens)
                    tokens.append(t)
                    parents.append(cur)
                    kids[cur][t] = node
                cur = node
        return cls(tokens, parents)

    @property
    def nodes(self) -> int:
        return len(self.tokens)

    def depth(self) -> int:
        """Longest root-to-leaf path in nodes (a chain of k drafts has
        depth k)."""
        best = 0
        d = [0] * len(self.tokens)
        for i, p in enumerate(self.parents):
            d[i] = 1 if p < 0 else d[p] + 1
            best = max(best, d[i])
        return best

    def children(self, node: int) -> List[int]:
        """Child node indices of `node` (-1 = the root), in proposal
        order — the acceptance walk's candidate order."""
        return [i for i, p in enumerate(self.parents) if p == node]

    def is_chain(self) -> bool:
        return all(p == i - 1 for i, p in enumerate(self.parents))

    def chains(self) -> List[List[int]]:
        """Root-to-leaf token paths (testing/debugging view)."""
        kids_of: Dict[int, List[int]] = {}
        for i, p in enumerate(self.parents):
            kids_of.setdefault(p, []).append(i)
        out: List[List[int]] = []

        def walk(node: int, path: List[int]) -> None:
            ks = kids_of.get(node, [])
            if not ks:
                out.append(path)
                return
            for c in ks:
                walk(c, path + [int(self.tokens[c])])

        walk(-1, [])
        return [p for p in out if p]

    def row_parents(self, w: Optional[int] = None) -> List[int]:
        """Per-VERIFY-ROW parent table of width `w` (>= 1 + nodes): row 0
        is the root (-1), row 1 + i is node i, padding rows chain (parent
        j - 1) so their mask degenerates to the staircase. This is the
        [w] slice the engine stacks into the [max_seqs, w] parents
        operand."""
        n = len(self.tokens)
        w = 1 + n if w is None else int(w)
        if w < 1 + n:
            raise ValueError(f"width {w} < 1 + {n} nodes")
        rows = [-1] + [0 if p < 0 else 1 + p for p in self.parents]
        rows += list(range(n, w - 1))  # chain padding: row j's parent j-1
        return rows

    def prune(
        self,
        max_nodes: Optional[int] = None,
        max_depth: Optional[int] = None,
    ) -> "DraftTree":
        """Drop nodes past a depth and/or node budget. Topological order
        means keeping a prefix of the node list keeps every survivor's
        parent, and the depth filter keeps ancestors by construction."""
        d = [0] * len(self.tokens)
        for i, p in enumerate(self.parents):
            d[i] = 1 if p < 0 else d[p] + 1
        idx_map: Dict[int, int] = {}
        tokens: List[int] = []
        parents: List[int] = []
        for i, p in enumerate(self.parents):
            if max_nodes is not None and len(tokens) >= max_nodes:
                break
            if max_depth is not None and d[i] > max_depth:
                continue
            if p >= 0 and p not in idx_map:
                continue  # orphaned by the node cap
            idx_map[i] = len(tokens)
            tokens.append(int(self.tokens[i]))
            parents.append(-1 if p < 0 else idx_map[p])
        return DraftTree(tokens, parents)


def accept_tree(
    row_logits: np.ndarray,
    tree: DraftTree,
    temperature: float = 0.0,
    seed: int = 0,
    slot: int = 0,
    base_len: int = 0,
) -> Tuple[List[int], List[int]]:
    """Tree acceptance for one slot's verify output — the multi-branch
    generalization of accept_drafts. row_logits [w >= 1 + nodes, vocab]:
    row 0 is the target's distribution after the last emitted token,
    row 1 + i its distribution after node i's root-to-node path.
    Returns (path, emitted): `path` is the surviving root-to-leaf node
    index prefix (the rows truncate compacts into the cache) and
    `emitted` is its tokens plus ONE token from the target.

    temperature 0: walk greedily — descend to the child whose token
    equals the argmax. temperature > 0: multi-candidate rejection
    sampling (candidates tried in proposal order against the running
    residual; with one candidate this is draw-for-draw accept_drafts)."""
    if temperature <= 0.0:
        path: List[int] = []
        emitted: List[int] = []
        cur = -1
        while True:
            row = 0 if cur < 0 else 1 + cur
            pred = int(np.argmax(row_logits[row]))
            emitted.append(pred)
            nxt = None
            for c in tree.children(cur):
                if int(tree.tokens[c]) == pred:
                    nxt = c
                    break
            if nxt is None:
                return path, emitted
            path.append(nxt)
            cur = nxt
    path = []
    emitted = []
    cur = -1
    depth = 0
    while True:
        row = 0 if cur < 0 else 1 + cur
        # position the decided token will occupy: base_len + 1 + depth
        pos = base_len + 1 + depth
        p = _softmax(row_logits[row] / temperature)
        kids = tree.children(cur)
        if not kids:  # fully-accepted leaf: bonus from the target
            t = int(_rng(seed, slot, pos, 0).choice(p.size, p=p))
            emitted.append(t)
            return path, emitted
        residual = p.copy()
        accepted_node = None
        for ordinal, c in enumerate(kids):
            d = int(tree.tokens[c])
            total = residual.sum()
            if total <= 0.0:  # p was a delta on rejected candidates
                accepted_node = c
                break
            u = _rng(
                seed, slot, pos, 0 if ordinal == 0 else 2 + ordinal
            ).random()
            # ordinal 0 compares against p[d] itself (total == 1), the
            # exact comparison accept_drafts makes
            thresh = residual[d] if ordinal == 0 else residual[d] / total
            if u <= thresh:
                accepted_node = c
                break
            residual[d] = 0.0
        if accepted_node is None:
            total = residual.sum()
            if total <= 0.0:  # delta at the last rejected candidate
                accepted_node = kids[-1]
            else:
                t = int(
                    _rng(seed, slot, pos, 1).choice(
                        residual.size, p=residual / total
                    )
                )
                emitted.append(t)
                return path, emitted
        path.append(accepted_node)
        emitted.append(int(tree.tokens[accepted_node]))
        cur = accepted_node
        depth += 1


# -- draft proposers ----------------------------------------------------------


class DraftProposer:
    """Protocol for draft sources. `propose` maps running slots to draft
    token lists (up to k each; shorter or empty is fine — the verify
    degrades to plain decode). The lifecycle hooks exist for proposers
    with their own cache state; the base implementations are no-ops, so
    stateless proposers only implement propose(). `stateless` marks
    proposers whose drafts are a pure function of the token sequence."""

    stateless = False

    def admit(self, requests: Sequence) -> None:
        pass

    def retire(self, request) -> None:
        pass

    def rollback(self, slot: int, new_len: int) -> None:
        pass

    def propose(self, running: Dict[int, object], k: int) -> Dict[int, List[int]]:
        raise NotImplementedError

    def propose_trees(
        self, running: Dict[int, object], k: int, branch: int
    ) -> Dict[int, DraftTree]:
        """Branching drafts: up to `branch` candidate chains of up to k
        tokens per slot, deduped into one DraftTree. The base
        implementation wraps propose() — a single chain IS the
        branch == 1 tree."""
        out: Dict[int, DraftTree] = {}
        for slot, drafts in self.propose(running, k).items():
            tree = DraftTree.from_chains([drafts])
            if tree.nodes:
                out[slot] = tree
        return out

    def propose_sequences(
        self, seqs: Dict[int, List[int]], k: int
    ) -> Dict[int, List[int]]:
        """Draft up to k continuation tokens for explicit token
        sequences (slot -> history) instead of live Request state."""
        raise NotImplementedError(
            "propose_sequences is only available on stateless proposers"
        )


class NGramDraftProposer(DraftProposer):
    """Weight-free prompt-lookup draft: propose the continuation that
    followed the most recent earlier occurrence of the sequence's
    trailing `n`-gram (prompt + generated so far). Repetitive text
    yields near-1 acceptance for zero draft cost; novel text yields no
    match and the iteration degrades to plain decode. `max_history`
    bounds the backward scan. `lookups` / `lookup_hits` count lookups
    attempted and those that found a continuation."""

    stateless = True

    def __init__(self, n: int = 2, max_history: int = 4096):
        if n < 1:
            raise ValueError("n-gram size must be >= 1")
        self.n = int(n)
        self.max_history = int(max_history)
        self.lookups = 0
        self.lookup_hits = 0

    def _lookup(self, seq: List[int], k: int) -> List[int]:
        if len(seq) > self.max_history:
            seq = seq[-self.max_history :]
        n = self.n
        if len(seq) <= n:
            return []
        tail = seq[-n:]
        # most recent earlier occurrence wins
        for i in range(len(seq) - n - 1, -1, -1):
            if seq[i : i + n] == tail:
                return [int(t) for t in seq[i + n : i + n + k]]
        return []

    def _lookup_chains(
        self, seq: List[int], k: int, branch: int
    ) -> List[List[int]]:
        """Up to `branch` DISTINCT continuations from distinct earlier
        occurrences of the trailing n-gram, most recent first — the
        first chain is exactly what _lookup returns."""
        if len(seq) > self.max_history:
            seq = seq[-self.max_history :]
        n = self.n
        if len(seq) <= n:
            return []
        tail = seq[-n:]
        chains: List[List[int]] = []
        for i in range(len(seq) - n - 1, -1, -1):
            if seq[i : i + n] == tail:
                cont = [int(t) for t in seq[i + n : i + n + k]]
                if cont and cont not in chains:
                    chains.append(cont)
                if len(chains) >= branch:
                    break
        return chains

    def propose_trees(
        self, running, k: int, branch: int
    ) -> Dict[int, DraftTree]:
        return self.propose_tree_sequences(
            {
                slot: list(req.prompt) + list(req.generated)
                for slot, req in running.items()
            },
            k,
            branch,
        )

    def propose_tree_sequences(
        self, seqs: Dict[int, List[int]], k: int, branch: int
    ) -> Dict[int, DraftTree]:
        """Tree analog of propose_sequences."""
        out: Dict[int, DraftTree] = {}
        for slot, seq in seqs.items():
            self.lookups += 1
            chains = self._lookup_chains(list(seq), k, branch)
            if chains:
                self.lookup_hits += 1
                out[slot] = DraftTree.from_chains(chains)
        return out

    def propose(self, running, k: int) -> Dict[int, List[int]]:
        return self.propose_sequences(
            {
                slot: list(req.prompt) + list(req.generated)
                for slot, req in running.items()
            },
            k,
        )

    def propose_sequences(
        self, seqs: Dict[int, List[int]], k: int
    ) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        for slot, seq in seqs.items():
            self.lookups += 1
            cont = self._lookup(list(seq), k)
            if cont:
                self.lookup_hits += 1
                out[slot] = cont
        return out
