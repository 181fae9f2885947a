"""The drivers of the traffic modes, one module each, named by a traffic
file's ``mode``."""
