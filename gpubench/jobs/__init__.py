"""Job kinds, one module each, named by a traffic file's ``"job"``."""
