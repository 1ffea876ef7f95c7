"""l1_topk kernel: plain version (``ref``) and wrapper (``ops``)."""
