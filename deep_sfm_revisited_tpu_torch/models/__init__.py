"""DICL, PWC-DC and RAFT flow, PSNet depth and the SFMNet composite of the port."""
