"""Runtime services of the port: the compressed candidate payload and the
index memory accountant (counterparts of ``repro.runtime.payload`` and
``repro.runtime.memory``)."""
