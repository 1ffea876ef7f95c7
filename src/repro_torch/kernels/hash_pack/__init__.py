"""hash_pack kernel: plain version (``ref``) and wrapper (``ops``)."""
