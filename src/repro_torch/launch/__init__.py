"""Command-line launchers, ported from ``repro.launch``: ``serve``."""
