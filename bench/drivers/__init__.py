"""One module per kind of loop; a mix file's ``driver`` names it."""
