"""Entity/Relation data model (numpy only).

Port of ``bayesiandatafusion_jl_tpu/models/data.py``: the same classes, the
same graph building (``add_relation``, ``from_matrix``) and the same test
split for the same seed.  The JAX package's copy cannot be imported here,
since importing any of its modules imports jax.  Side features
(``Entity(F=...)``, ``from_matrix``'s ``feat1`` / ``feat2``) are ROADMAP M8
and raise.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np


class IndexedDF:
    """N-way sparse relation: integer index columns + a value column."""

    def __init__(self, idx: np.ndarray, vals: np.ndarray,
                 shape: Sequence[int]):
        idx = np.asarray(idx)
        if idx.ndim != 2:
            raise ValueError("idx must be [nnz, D]")
        self.idx = np.ascontiguousarray(idx, np.int32)
        self.vals = np.asarray(vals, np.float64).ravel()
        if self.vals.shape[0] != self.idx.shape[0]:
            raise ValueError("idx and vals length mismatch")
        self.shape = tuple(int(s) for s in shape)
        if len(self.shape) != self.idx.shape[1]:
            raise ValueError("shape arity mismatch")
        for d, s in enumerate(self.shape):
            if self.idx.shape[0] and (self.idx[:, d].min() < 0
                                      or self.idx[:, d].max() >= s):
                raise ValueError(f"index out of range in mode {d}")

    @property
    def nnz(self) -> int:
        return int(self.idx.shape[0])

    @property
    def arity(self) -> int:
        return len(self.shape)

    def degrees(self, mode: int) -> np.ndarray:
        return np.bincount(self.idx[:, mode], minlength=self.shape[mode])

    def index(self, mode: int) -> List[np.ndarray]:
        """Inverted index: per-instance observation row ids."""
        order = np.argsort(self.idx[:, mode], kind="stable")
        ptr = np.concatenate([[0], np.cumsum(self.degrees(mode))])
        return [order[ptr[i]:ptr[i + 1]] for i in range(self.shape[mode])]

    def remove_samples(self, rows: np.ndarray) -> "IndexedDF":
        keep = np.ones(self.nnz, bool)
        keep[np.asarray(rows, np.int64)] = False
        return IndexedDF(self.idx[keep], self.vals[keep], self.shape)

    @classmethod
    def from_dense(cls, m: np.ndarray) -> "IndexedDF":
        """The nonzero cells of a dense array."""
        m = np.asarray(m)
        nz = np.nonzero(m)
        return cls(np.stack(nz, axis=1), m[nz], m.shape)

    @classmethod
    def from_scipy(cls, m) -> "IndexedDF":
        """The stored cells of a scipy sparse matrix (anything with
        ``tocoo``)."""
        coo = m.tocoo()
        return cls(np.stack([coo.row, coo.col], axis=1), coo.data, coo.shape)


class Entity:
    """One entity type (e.g. user, movie)."""

    def __init__(self, name: str, count: Optional[int] = None, F=None):
        if F is not None:
            raise NotImplementedError(
                "side features are not ported yet (ROADMAP M8)")
        self.name = name
        self.count = count

    def __repr__(self):
        return f"Entity({self.name!r}, count={self.count})"


class RelationModel:
    """Per-relation overrides; None means "use the MacauConfig value"."""

    def __init__(self):
        self.alpha: Optional[float] = None
        self.alpha_sample: Optional[bool] = None


def resolved_alpha(rel: "Relation", cfg) -> float:
    a = rel.model.alpha
    return float(cfg.alpha if a is None else a)


def resolved_alpha_sample(rel: "Relation", cfg) -> bool:
    s = rel.model.alpha_sample
    return bool(cfg.alpha_sample if s is None else s)


class Relation:
    """One observed sparse relation over D >= 2 entities."""

    def __init__(self, data: IndexedDF, name: str,
                 entities: Sequence[Entity],
                 class_cut: Optional[float] = None):
        if len(entities) != data.arity:
            raise ValueError("entities list must match relation arity")
        for d, e in enumerate(entities):
            if e.count is None:
                e.count = data.shape[d]
            elif e.count != data.shape[d]:
                raise ValueError(
                    f"entity {e.name} count {e.count} != relation dim "
                    f"{data.shape[d]} (mode {d})")
        self.name = name
        self.data = data
        self.entities = list(entities)
        self.class_cut = class_cut
        self.model = RelationModel()
        self.test_idx: np.ndarray = np.zeros((0, data.arity), np.int32)
        self.test_vals: np.ndarray = np.zeros((0,), np.float64)

    @property
    def arity(self) -> int:
        return self.data.arity

    def set_test(self, idx: np.ndarray, vals: np.ndarray) -> None:
        self.test_idx = np.ascontiguousarray(idx, np.int32)
        self.test_vals = np.asarray(vals, np.float64).ravel()

    def __repr__(self):
        return (f"Relation({self.name!r}, shape={self.data.shape}, "
                f"nnz={self.data.nnz}, test={len(self.test_vals)})")


class RelationData:
    """The fusion graph: entities + relations."""

    def __init__(self, entities: Optional[Sequence[Entity]] = None,
                 relations: Optional[Sequence[Relation]] = None):
        self.entities: List[Entity] = list(entities or [])
        self.relations: List[Relation] = list(relations or [])

    @classmethod
    def from_matrix(cls, m, feat1=None, feat2=None,
                    names: Tuple[str, str] = ("ent1", "ent2"),
                    relation_name: str = "rel",
                    class_cut: Optional[float] = None) -> "RelationData":
        """One relation from a matrix: an IndexedDF, a scipy sparse matrix
        (its stored cells) or a dense array (its nonzero cells)."""
        if hasattr(m, "tocoo"):
            df = IndexedDF.from_scipy(m)
        elif isinstance(m, IndexedDF):
            df = m
        else:
            df = IndexedDF.from_dense(np.asarray(m))
        e1 = Entity(names[0], count=df.shape[0], F=feat1)
        e2 = Entity(names[1], count=df.shape[1], F=feat2)
        rel = Relation(df, relation_name, [e1, e2], class_cut=class_cut)
        return cls([e1, e2], [rel])

    @classmethod
    def from_indexed_df(cls, df: IndexedDF,
                        entities: Optional[Sequence[Entity]] = None,
                        relation_name: str = "rel",
                        class_cut: Optional[float] = None) -> "RelationData":
        if entities is None:
            entities = [Entity(f"ent{d+1}", count=df.shape[d])
                        for d in range(df.arity)]
        rel = Relation(df, relation_name, entities, class_cut=class_cut)
        return cls(list(entities), [rel])

    def add_relation(self, df: IndexedDF, name: str,
                     entities: Sequence[Entity],
                     class_cut: Optional[float] = None) -> Relation:
        """Add a relation over ``entities`` (one per mode; an entity may
        fill several modes, and entities new to the graph join it)."""
        rel = Relation(df, name, entities, class_cut=class_cut)
        for e in entities:
            if e not in self.entities:
                self.entities.append(e)
        self.relations.append(rel)
        return rel

    def set_precision(self, relation: Union[Relation, int, str],
                      alpha: float, sample: bool = False) -> None:
        rel = self._rel(relation)
        rel.model.alpha = float(alpha)
        rel.model.alpha_sample = bool(sample)

    def _rel(self, r: Union[Relation, int, str]) -> Relation:
        if isinstance(r, Relation):
            return r
        if isinstance(r, int):
            return self.relations[r]
        for rel in self.relations:
            if rel.name == r:
                return rel
        raise KeyError(r)

    def assign_to_test(self, relation: Union[Relation, int, str],
                       n_or_rows: Union[int, np.ndarray],
                       seed: int = 0) -> None:
        """Move n random observed entries (or the given rows) to the test
        set — the same rows as the JAX package for the same seed."""
        rel = self._rel(relation)
        df = rel.data
        if np.isscalar(n_or_rows) or np.ndim(n_or_rows) == 0:
            n = int(n_or_rows)
            if n > df.nnz:
                raise ValueError("test size exceeds nnz")
            rng = np.random.default_rng(seed)
            rows = rng.choice(df.nnz, size=n, replace=False)
        else:
            rows = np.asarray(n_or_rows, np.int64)
        rows = np.sort(rows)
        rel.set_test(df.idx[rows], df.vals[rows])
        rel.data = df.remove_samples(rows)

    def __repr__(self):
        return (f"RelationData(entities={[e.name for e in self.entities]}, "
                f"relations={self.relations})")
