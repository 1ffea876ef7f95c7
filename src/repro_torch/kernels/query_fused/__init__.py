"""query_fused kernel: plain version (``ref``) and wrapper (``ops``)."""
