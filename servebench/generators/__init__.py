"""Traffic generators, one module each, found by the name a mix file
gives under ``generator`` (``servebench/traffic.py`` states the
interface)."""
