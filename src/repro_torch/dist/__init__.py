"""Placement rules for distributed runs (the port's copy of `repro.dist`)."""
