"""One driver per kind of cell (``train``), found by the
workload's ``kind``; a new kind is a new file here."""
