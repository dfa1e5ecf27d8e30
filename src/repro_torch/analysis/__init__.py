"""Analysis of compiled programs: post-SPMD HLO text (:mod:`.hlo`)."""
