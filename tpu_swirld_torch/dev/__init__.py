"""Development measurements of the card, outside the port's build and main
path."""
