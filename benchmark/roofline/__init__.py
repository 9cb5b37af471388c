"""Byte and FLOP counts of the work a cell needs, from its shapes alone.

Each count is of what the algorithm must move or compute for the given
inputs, whatever implements it: each input byte read once, each output
byte written once.  A bound is the larger of the FLOP time and the byte
time at the published peaks (:mod:`.peaks`).  None of these functions
reads anything of the port.
"""
