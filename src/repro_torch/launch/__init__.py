"""Entry points of the port's LM serving path (``serve``)."""
