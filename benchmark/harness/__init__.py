"""What every cell shares: the files found by name, the seeded weights,
the trace's arithmetic and the comparison's numbers."""
