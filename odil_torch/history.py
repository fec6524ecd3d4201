"""Training history: scalar metrics collected per epoch, streamed to CSV.

Same external contract as the reference's column store
(``src/odil/history.py``): one ``train.csv`` with a header that freezes
after ``warmup`` entries, zero-backfill for columns that appear late,
errors on columns appearing after the freeze, and a ``{column: [values]}``
pickle for checkpoint/resume.  The implementation is row-oriented instead:
metrics accumulate into a pending-row dict, ``commit`` seals it against the
column registry, and a small CSV sink tracks what still needs flushing.

The port's own copy of ``odil_tpu/history.py`` (numpy only): the same
columns, order and warm-up, so a ``train.csv`` of either package reads the
same.
"""

import pickle

import numpy as np

__all__ = ["History"]

_SCALARS = (int, float, str, np.floating)


def _zero_of(value):
    """The backfill/placeholder value matching a recorded value's type."""
    if value is None:
        return None
    if isinstance(value, bool):
        return False
    if isinstance(value, str):
        return ""
    if isinstance(value, (int, np.integer)):
        return 0
    if isinstance(value, (float, np.floating)):
        return 0.0
    raise ValueError("Unknown type: " + str(type(value)))


class _CsvSink:
    """Streams committed rows to a CSV file, freezing the column set at the
    first written row.  Flushes are incremental: only rows [nwritten, count)
    are formatted, so long runs stream in O(new rows), not O(history)."""

    def __init__(self, path):
        self.file = open(path, "w") if path is not None else None
        self.header = None  # Frozen column order, or None before first write.
        self.nwritten = 0

    def flush(self, rows, born, count):
        """Writes rows [nwritten, count) of the committed row dicts; a row
        predating a column's birth (possible within warmup only) gets the
        type-matched zero of the column's first value."""
        if self.file is None:
            return
        if self.header is None:
            self.header = list(born)
            self.file.write(",".join(self.header) + "\n")
        elif len(born) != len(self.header):
            extra = sorted(set(born) - set(self.header))
            raise RuntimeError(f"Unexpected keys in history: {extra}")
        while self.nwritten < count:
            row = rows[self.nwritten]
            vals = [
                str(row[k]) if k in row else str(_zero_of(rows[born[k]][k]))
                for k in self.header
            ]
            self.file.write(",".join(vals) + "\n")
            self.nwritten += 1
        self.file.flush()

    def close(self):
        if self.file is not None:
            self.file.close()


class History:

    def __init__(self, csvpath=None, warmup=0):
        """
        warmup: hold the first `warmup` entries back from the CSV, so
        columns that only appear from the second entry on (per-example
        extras) still make it into the header.
        """
        self._rows = []  # Committed entries, each a {column: value} dict.
        self._pending = {}  # The entry being assembled by append() calls.
        self._born = {}  # column -> index of the row where it first appeared.
        self.warmup = warmup
        self.csvpath = csvpath
        self._sink = _CsvSink(csvpath)

    # -- Recording -----------------------------------------------------------

    def append(self, key, value=None):
        """Records one metric of the current entry.  value=None writes a
        zero of the column's type (the reference's placeholder idiom)."""
        if isinstance(value, np.ndarray):
            assert value.shape == (1,) or value.ndim == 0
            value = value.item()
        assert value is None or isinstance(value, _SCALARS), (
            "Unexpected type: " + str(type(value))
        )
        if key not in self._born:
            assert value is not None, f"First value for column '{key}' must be set"
            self._born[key] = len(self._rows)
        if value is None:
            last = self._pending.get(key)
            if last is None:
                for row in reversed(self._rows):
                    if key in row:
                        last = row[key]
                        break
            assert last is not None, "Expected non-empty column " + key
            value = _zero_of(last)
        self._pending[key] = value

    def append_dict(self, entries):
        for k, v in entries.items():
            self.append(k, v)

    def commit(self):
        """Seals the pending entry: every registered column must be set."""
        missing = [k for k in self._born if k not in self._pending]
        if missing:
            raise RuntimeError("Missing values for columns: " + ",".join(missing))
        self._rows.append(self._pending)
        self._pending = {}

    # -- Access --------------------------------------------------------------

    @property
    def count(self):
        return len(self._rows)

    @property
    def data(self):
        """Columnar {key: [values]} view (the reference's native layout),
        zero-backfilled before each column's first appearance.  The zero is
        only computed for columns born late (committed rows always carry
        every column registered at their commit), so str/bool columns born
        at row 0 need no numeric placeholder."""
        return {key: self._column(key) for key in self._born}

    def _column(self, key):
        born = self._born[key]
        if born >= len(self._rows):  # Registered by a pending append only.
            return [None] * len(self._rows)
        if born == 0:
            return [row[key] for row in self._rows]
        zero = _zero_of(self._rows[born][key])
        return [row.get(key, zero) for row in self._rows]

    def get(self, key, default=None):
        if key not in self._born:
            return default
        return self._column(key)

    # -- Output --------------------------------------------------------------

    def write(self, nocommit=False):
        if not nocommit:
            self.commit()
        if self.count <= self.warmup:
            return
        self._sink.flush(self._rows, self._born, self.count)

    def save(self, path):
        with open(path, "wb") as f:
            pickle.dump(self.data, f)

    def load(self, path):
        """Replaces the history with a pickled columnar dump (resume)."""
        with open(path, "rb") as f:
            columns = pickle.load(f)
        counts = {len(v) for v in columns.values()}
        assert len(counts) == 1, f"Ragged history columns: {counts}"
        self._born = {k: 0 for k in columns}
        n = counts.pop()
        self._rows = [{k: columns[k][i] for k in columns} for i in range(n)]
        self._pending = {}
        self.write(nocommit=True)

    def close(self):
        self._sink.close()
