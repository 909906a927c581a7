"""Containers of the plain reference, one file a format, found by the
configuration's ``format``: ``fault(blob, data, window_bits)`` says why
an answer is not one stream of its buffer (None when it is),
``zero_check(blob)`` zeroes the trailer's checksum (the encoders'
control), and ``body_bytes(blob)`` is the length of the deflate data."""
