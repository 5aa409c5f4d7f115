"""Frequent pattern mining: FP-Growth and association rules.

Parity: ``mllib/src/main/scala/org/apache/spark/mllib/fpm/FPGrowth.scala``
and ``AssociationRules.scala`` -- conditional FP-tree mining with a minimum
support threshold, then rules filtered by confidence.

Host-side by design: frequent-itemset mining is symbolic tree recursion
over hash maps -- no dense array structure for a TPU to accelerate, and the
reference's distribution strategy (group-dependent transactions) exists for
datasets far beyond this framework's single-host scope.  The capability is
the API and the exact semantics; the compute is pointer-chasing either way.

A copy of ``asyncframework_tpu/ml/fpm.py`` (pure Python); the JAX
package's FP-growth, PrefixSpan and association-rule tests run on this
copy (``tests/test_torch_ml_breadth.py``).
"""

from __future__ import annotations

from collections import Counter, defaultdict
from dataclasses import dataclass
from typing import Dict, FrozenSet, Iterable, List, Sequence, Tuple


class _FPNode:
    __slots__ = ("item", "count", "parent", "children")

    def __init__(self, item, parent):
        self.item = item
        self.count = 0
        self.parent = parent
        self.children: Dict[object, _FPNode] = {}


def _build_tree(transactions, min_count):
    """(root, header links item -> [nodes]) for the frequent items only.

    ``transactions`` is a sequence of item iterables, or a dict mapping a
    path tuple to its multiplicity (conditional pattern bases) -- item
    frequencies MUST be weighted by that multiplicity.
    """
    weighted = (
        list(transactions.items())
        if isinstance(transactions, dict)
        else [(t, 1) for t in transactions]
    )
    freq = Counter()
    for t, mult in weighted:
        for i in set(t):
            freq[i] += mult
    keep = {i for i, c in freq.items() if c >= min_count}
    order = {i: (-freq[i], repr(i)) for i in keep}  # support-desc, stable
    root = _FPNode(None, None)
    header: Dict[object, List[_FPNode]] = defaultdict(list)
    for t, mult in weighted:
        items = sorted(set(t) & keep, key=lambda i: order[i])
        node = root
        for item in items:
            child = node.children.get(item)
            if child is None:
                child = _FPNode(item, node)
                node.children[item] = child
                header[item].append(child)
            child.count += mult
            node = child
    return root, header, freq, keep


def _mine(header, min_count, suffix, out):
    # items ascending by support: mine least-frequent first (classic order)
    for item in sorted(header, key=lambda i: sum(n.count for n in header[i])):
        nodes = header[item]
        support = sum(n.count for n in nodes)
        if support < min_count:
            continue
        itemset = suffix | {item}
        out[frozenset(itemset)] = support
        # conditional pattern base: prefix paths with this node's count
        conditional: Dict[Tuple, int] = defaultdict(int)
        for n in nodes:
            path = []
            p = n.parent
            while p is not None and p.item is not None:
                path.append(p.item)
                p = p.parent
            if path:
                conditional[tuple(path)] += n.count
        if conditional:
            _root, sub_header, _f, _k = _build_tree(
                dict(conditional), min_count
            )
            _mine(sub_header, min_count, itemset, out)


@dataclass(frozen=True)
class Rule:
    antecedent: FrozenSet
    consequent: FrozenSet
    confidence: float
    support: float  # of antecedent+consequent, as a fraction


class FPGrowthModel:
    def __init__(self, itemsets: Dict[FrozenSet, int], num_transactions: int):
        self.freq_itemsets = itemsets
        self.num_transactions = num_transactions

    def itemsets(self) -> List[Tuple[FrozenSet, int]]:
        """Frequent itemsets with absolute support counts, support-desc."""
        return sorted(
            self.freq_itemsets.items(),
            key=lambda kv: (-kv[1], sorted(map(repr, kv[0]))),
        )

    def association_rules(self, min_confidence: float = 0.8) -> List[Rule]:
        """``AssociationRules.run`` parity: single-consequent rules X -> y
        with confidence = support(X+y) / support(X)."""
        rules: List[Rule] = []
        for items, count in self.freq_itemsets.items():
            if len(items) < 2:
                continue
            for y in items:
                antecedent = items - {y}
                base = self.freq_itemsets.get(antecedent)
                if not base:
                    continue
                conf = count / base
                if conf >= min_confidence:
                    rules.append(Rule(
                        antecedent=antecedent,
                        consequent=frozenset({y}),
                        confidence=conf,
                        support=count / self.num_transactions,
                    ))
        return sorted(
            rules, key=lambda r: (-r.confidence, sorted(map(repr, r.antecedent)))
        )


class AssociationRules:
    """Standalone rule generator (``AssociationRules.scala`` public API):
    takes pre-mined (itemset, count) pairs, emits single-consequent rules.
    ``FPGrowthModel.association_rules`` delegates the same logic."""

    def __init__(self, min_confidence: float = 0.8):
        if not 0.0 <= min_confidence <= 1.0:
            raise ValueError("min_confidence must be in [0, 1]")
        self.min_confidence = min_confidence

    def run(
        self,
        freq_itemsets: Iterable[Tuple[Iterable, int]],
        num_transactions: int,
    ) -> List[Rule]:
        if num_transactions < 1:
            # support fractions are counts / num_transactions; guessing the
            # denominator would silently misreport every rule's support
            raise ValueError("num_transactions must be >= 1")
        table = {frozenset(items): int(c) for items, c in freq_itemsets}
        return FPGrowthModel(table, num_transactions).association_rules(
            self.min_confidence
        )


@dataclass(frozen=True)
class FreqSequence:
    """A frequent sequential pattern: a tuple of itemsets + its support."""

    sequence: Tuple[FrozenSet, ...]
    freq: int


class PrefixSpan:
    """Sequential pattern mining by prefix-projected growth.

    Parity: ``mllib/src/main/scala/org/apache/spark/mllib/fpm/
    PrefixSpan.scala`` -- patterns are sequences of itemsets, grown one
    item at a time either by EXTENDING the last itemset (same-element
    growth) or APPENDING a new itemset, counting support in the projected
    database (Pei et al.'s PrefixSpan).  ``min_support`` is a fraction of
    sequences; ``max_pattern_length`` bounds the total item count.

    Host-side for the same reason as FP-Growth (symbolic recursion over
    projections; the reference distributes only to shard candidate
    prefixes).
    """

    def __init__(
        self,
        min_support: float = 0.1,
        max_pattern_length: int = 10,
    ):
        if not 0.0 < min_support <= 1.0:
            raise ValueError("min_support must be in (0, 1]")
        if max_pattern_length < 1:
            raise ValueError("max_pattern_length must be >= 1")
        self.min_support = min_support
        self.max_len = max_pattern_length

    def run(self, sequences: Sequence[Sequence[Iterable]]) -> List[FreqSequence]:
        import math

        db = [[frozenset(ev) for ev in seq if ev] for seq in sequences]
        n = len(db)
        if n == 0:
            raise ValueError("no sequences")
        min_count = max(1, math.ceil(self.min_support * n - 1e-9))
        out: List[FreqSequence] = []
        # projections: list of (seq_idx, event_idx, within-event frontier)
        start = [(i, 0, frozenset()) for i in range(len(db))]
        self._grow((), start, db, min_count, 0, out)
        return sorted(
            out,
            key=lambda f: (-f.freq, len(f.sequence),
                           [sorted(map(repr, s)) for s in f.sequence]),
        )

    def _grow(self, prefix, proj, db, min_count, length, out):
        if length >= self.max_len:
            return
        # candidate growth items: 'append' starts a new itemset; 'extend'
        # adds to the prefix's last itemset (only items > frontier items
        # are considered, using repr order for a canonical form)
        append_support: Dict[object, set] = defaultdict(set)
        extend_support: Dict[object, set] = defaultdict(set)
        for (si, ei, frontier) in proj:
            seq = db[si]
            if frontier:
                # same-element extension: the current event must contain
                # the frontier and a strictly "later" item
                for ev_i in range(ei, len(seq)):
                    ev = seq[ev_i]
                    if frontier <= ev:
                        for item in ev - frontier:
                            if repr(item) > max(map(repr, frontier)):
                                extend_support[item].add(si)
            for ev_i in range(ei + (1 if frontier else 0), len(seq)):
                for item in seq[ev_i]:
                    append_support[item].add(si)
        for item, seqs in sorted(
            extend_support.items(), key=lambda kv: repr(kv[0])
        ):
            if len(seqs) < min_count:
                continue
            last = prefix[-1] | {item}
            pattern = prefix[:-1] + (last,)
            out.append(FreqSequence(pattern, len(seqs)))
            new_proj = []
            for (si, ei, frontier) in proj:
                if si not in seqs or not frontier:
                    continue
                seq = db[si]
                for ev_i in range(ei, len(seq)):
                    if last <= seq[ev_i]:
                        new_proj.append((si, ev_i, last))
                        break
            self._grow(pattern, new_proj, db, min_count, length + 1, out)
        for item, seqs in sorted(
            append_support.items(), key=lambda kv: repr(kv[0])
        ):
            if len(seqs) < min_count:
                continue
            pattern = prefix + (frozenset({item}),)
            out.append(FreqSequence(pattern, len(seqs)))
            new_proj = []
            for (si, ei, frontier) in proj:
                if si not in seqs:
                    continue
                seq = db[si]
                for ev_i in range(ei + (1 if frontier else 0), len(seq)):
                    if item in seq[ev_i]:
                        new_proj.append((si, ev_i, frozenset({item})))
                        break
            self._grow(pattern, new_proj, db, min_count, length + 1, out)


class FPGrowth:
    """``new FPGrowth().setMinSupport(s).run(transactions)`` analog."""

    def __init__(self, min_support: float = 0.3):
        if not 0.0 < min_support <= 1.0:
            raise ValueError("min_support must be in (0, 1]")
        self.min_support = min_support

    def run(self, transactions: Sequence[Iterable]) -> FPGrowthModel:
        txs = [list(t) for t in transactions]
        n = len(txs)
        if n == 0:
            raise ValueError("no transactions")
        import math

        min_count = max(1, math.ceil(self.min_support * n - 1e-9))
        _root, header, _freq, _keep = _build_tree(txs, min_count)
        out: Dict[FrozenSet, int] = {}
        _mine(header, min_count, frozenset(), out)
        return FPGrowthModel(out, n)
