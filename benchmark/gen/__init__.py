"""Inputs made from ``--seed`` on the run's device: the same seed gives
the same data.  Frozen here so that a change to the program cannot move
the yardstick."""
