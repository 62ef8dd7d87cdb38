"""Frozen counts: the card's peaks, the kernels' bounds, and per family of
configurations the dispatch predicates, the products each call runs and
the model FLOPs of a token.  Copies, so that the yardstick does not move
when the program does: a change to the program's dispatch shows as a
launch count that no longer matches, not as a silently moved bound."""
