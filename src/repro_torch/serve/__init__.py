"""LM serving, ported from ``repro.serve``: ``engine.ServeEngine``."""
