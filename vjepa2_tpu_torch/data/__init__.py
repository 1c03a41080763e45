"""Host-side data: synthetic clips and the prefetch to the card."""
