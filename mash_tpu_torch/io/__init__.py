"""Host-side I/O: FASTA/FASTQ streaming, Cap'n Proto .msh files, text output."""
