"""Hand-written GPU kernels (Pallas through Triton).

Only the fused requantizing MVM has one (:mod:`.mvm`): it is the one op
that streams the matrix, so it sets the pace of every solver and of the
server.  :mod:`clover_tpu.ops` chooses it on a GPU for the shapes it
takes and runs the plain XLA formulation everywhere else.
"""
