"""Runtime services of the port: the compressed candidate payload, the
index memory accountant, fault tolerance and elastic operations
(counterparts of ``repro.runtime.payload``, ``memory``, ``ft`` and
``elastic``)."""
