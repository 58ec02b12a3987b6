"""Extreme-event modeling (paper section II.A): the eq. 1 indicator
sequence (``indicators``) and the GEV tail machinery (``evt``)."""
