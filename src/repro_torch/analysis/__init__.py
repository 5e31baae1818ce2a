"""Analysis: the runtime contract sanitizer (``contracts``)."""
