"""Known-bad programs, one per runtime or source pass of the gate.

``python -m repro_torch.analysis --selftest`` fails unless each module's
pass (``EXPECT_PASS``) fires on it with a file:line anchor inside the
module's own file, so a pass that stops detecting its bug class cannot
turn the gate green. Each module defines ``EXPECT_PASS`` and
``build_bad(device)`` (and ``build_bad_large(device)`` where two sizes
are compared); importing one does nothing.
"""
