"""One loop per kind of traffic (``train``, ``sample``): it builds the
cell, runs its window and compares what the window's path produced with
the reference."""
