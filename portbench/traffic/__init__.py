"""Traffic kinds: one module each, looked up by the name a cell file gives."""
