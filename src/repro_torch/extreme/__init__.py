"""Extreme-event modeling (paper section II.A): the eq. 1 indicator
sequence and class fractions (``indicators``), the GEV tail machinery
(``evt``) and the Extreme Value Loss (``evl``)."""
