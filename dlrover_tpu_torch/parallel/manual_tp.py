"""Manual tensor-parallel annotation (port of
dlrover_tpu/parallel/manual_tp.py).

Tensor parallelism is a sharding annotation here as in the JAX package:
:class:`TPInfo` collects column-, row- and vocab-parallel declarations
keyed by substrings of the params' dotted names and emits the logical
axes ``auto_accelerate`` places the params by (``param_logical_axes``).
On a ``tensor`` axis the default rules map them to ``Shard`` placements,
and the models' explicit f and g (parallel/shard_ops.py) are the
collectives Megatron's Col/RowParallel layers issue by hand.

    tp = TPInfo(vocab_size=32000)
    tp.shard_col("wq", "wk", "wv", "w_gate", "w_up")
    tp.shard_row("wo", "w_down")
    tp.shard_vocab("embed", "lm_head")
    axes = tp.build_axes(params)

``vocab_size`` is required when vocab-parallel params are 2-D: a
``(vocab, dim)`` embed and a ``(dim, vocab)`` lm_head cannot be told
apart by shape alone, so ``build_axes`` refuses to guess.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["TPInfo"]

# logical names DEFAULT_RULES maps onto the ``tensor`` mesh axis
_COL = "mlp"      # output dim sharded  -> column parallel
_ROW = "mlp"      # input dim sharded   -> row parallel
_VOCAB = "vocab"


class TPInfo:
    """Collects col/row/vocab declarations and builds logical axes.

    A declaration matches the params whose dotted name CONTAINS it.
    Column parallel shards the LAST dim, row parallel the FIRST (after a
    stacked layer dim), vocab parallel the dim whose size is
    ``vocab_size`` (required for 2-D vocab params; a 1-D vocab-length
    bias shards its only dim). Unmatched params get replicated (all
    None) axes."""

    def __init__(self, vocab_size: Optional[int] = None):
        self._col: list = []
        self._row: list = []
        self._vocab: list = []
        self._vocab_size = vocab_size

    def shard_col(self, *names: str) -> "TPInfo":
        self._col.extend(names)
        return self

    def shard_row(self, *names: str) -> "TPInfo":
        self._row.extend(names)
        return self

    def shard_vocab(self, *names: str) -> "TPInfo":
        self._vocab.extend(names)
        return self

    def _axes_for(self, path: str, ndim: int, shape) -> tuple:
        axes: list = [None] * ndim
        if ndim == 0:
            return tuple(axes)
        stacked = path.startswith("layers.") or ".layers." in path
        lead = 1 if stacked and ndim > 1 else 0
        if lead:
            axes[0] = "layer"
        if any(n in path for n in self._vocab):
            if self._vocab_size is not None:
                for d in range(lead, ndim):
                    if shape[d] == self._vocab_size:
                        dim = d
                        break
                else:
                    raise ValueError(
                        f"vocab-parallel param {path!r} has no dim of "
                        f"size {self._vocab_size} (shape {tuple(shape)})"
                        " — padded vocab? pass the padded size")
            elif ndim - lead >= 2:
                # a (vocab, dim) embed and a (dim, vocab) lm_head look
                # alike: guessing would mis-shard the head
                raise ValueError(
                    f"vocab-parallel param {path!r} is ambiguous "
                    f"(shape {tuple(shape)}): pass "
                    "TPInfo(vocab_size=...) so the vocab dim can be "
                    "identified")
            else:
                dim = lead  # a vocab-length bias: its only dim
            axes[dim] = _VOCAB
        elif any(n in path for n in self._col):
            axes[ndim - 1] = _COL
        elif any(n in path for n in self._row):
            # a 1-D row-parallel param (a bias) stays replicated
            if ndim - lead >= 2:
                axes[lead] = _ROW
        return tuple(axes)

    def build_axes(self, params: dict) -> dict:
        """``{name: logical axes}`` for a flat ``{name: tensor}`` dict
        (``param_logical_axes`` of ``auto_accelerate``). A param under a
        stacked ``layers`` prefix keeps its leading ``layer`` axis."""
        out = {}
        for name, leaf in params.items():
            shape = tuple(getattr(leaf, "shape", ()))
            out[name] = self._axes_for(name, len(shape), shape)
        return out
