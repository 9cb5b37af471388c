"""Studies run on the card by hand: readings for the limits, and the spread of a cell's runs."""
