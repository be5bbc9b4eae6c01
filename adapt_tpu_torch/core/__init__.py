"""Device lists (``mesh``) and stages bound to a device (``stage``)."""
