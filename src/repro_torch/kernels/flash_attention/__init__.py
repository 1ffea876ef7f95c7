"""flash_attention kernel: plain version (``ref``) and wrapper (``ops``)."""
