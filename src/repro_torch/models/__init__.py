"""Language models of the port: the dense family's forward pass (prefill
and decode), with attention through the flash kernel on the card."""
