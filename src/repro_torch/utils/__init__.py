"""Mesh utilities of the LM (a port of the reference's ``repro.utils``):
the activation-sharding context (``meshctx``) and the op counter the dry
run reads in place of HLO (``opcount``)."""
