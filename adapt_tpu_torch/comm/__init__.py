"""The cross-process half of the paper's pipeline: wire framing
(``framing``), tensor codecs (``codec``, ``native``) and remote stage
workers (``remote``)."""
