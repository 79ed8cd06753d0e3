"""Training-side helpers of the port (so far only greedy sampling)."""
