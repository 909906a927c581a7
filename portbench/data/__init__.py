"""Data sources of the traffic mixes, one file each, found by the name a
mix gives under ``"data"``: ``make(nbytes, seed)`` returns one buffer."""
