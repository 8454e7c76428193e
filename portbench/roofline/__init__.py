"""Work counts of kernels: the bytes (or operations) that the work itself
needs, whatever the implementation's layout; a kernel's roofline share is
the time these take at the card's peak over its measured time."""
