"""Per-device memory watermark sampling: the port's form of the JAX
package's ``obs/memory.py``.

``torch.cuda.memory_stats()`` reads the caching allocator's counters on
the host, and ``torch.cuda.mem_get_info()`` asks the driver for the
card's free and total bytes; neither waits for the card's stream, so
sampling them at epoch boundaries adds nothing to the hot path. The
counters are mapped onto the JAX keys: ``bytes_in_use`` (allocated now),
``peak_bytes_in_use`` (allocated at most since the last reset),
``bytes_reserved`` (held by the allocator) and ``bytes_limit`` (the
card's total). ``largest_alloc_size`` has no counterpart and is left out,
as the JAX function leaves out keys a backend lacks. On the CPU the event
still comes, with ``available: false``, as JAX's CPU backend gives it.
"""

from __future__ import annotations

from typing import List, Optional

# JAX key <- torch.cuda.memory_stats() key.
_STATS_KEYS = (
    ("bytes_in_use", "allocated_bytes.all.current"),
    ("peak_bytes_in_use", "allocated_bytes.all.peak"),
    ("bytes_reserved", "reserved_bytes.all.current"),
)


def memory_watermarks(devices: Optional[List] = None) -> dict:
    """Snapshot allocator watermarks for each local device (every card,
    or the torch.devices given; a CPU device reports no counters)."""
    import torch

    if devices is None:
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if torch.cuda.is_available() else [torch.device("cpu")])
    rows = []
    available = False
    for d in devices:
        d = torch.device(d)
        if d.type != "cuda":
            rows.append({"id": 0, "kind": "cpu"})
            continue
        index = d.index if d.index is not None else torch.cuda.current_device()
        row: dict = {"id": index, "kind": torch.cuda.get_device_name(index)}
        try:
            stats = torch.cuda.memory_stats(index)
            _, total = torch.cuda.mem_get_info(index)
        except RuntimeError:
            stats, total = None, None
        if stats:
            available = True
            for key, source in _STATS_KEYS:
                if source in stats:
                    row[key] = int(stats[source])
            row["bytes_limit"] = int(total)
        rows.append(row)
    return {"available": available, "devices": rows}
