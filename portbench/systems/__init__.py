"""Drivers of the program under test, one module per configuration's
``system`` key: set-up, one request, the traced slice and the check."""
