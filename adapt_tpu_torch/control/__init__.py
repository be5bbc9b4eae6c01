"""The adaptive control plane of the port: worker membership
(``registry``), stage workers (``worker``) and the late-binding dispatcher
with its watchdog (``dispatcher``)."""
