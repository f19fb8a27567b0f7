#!/usr/bin/perl
# Test oracle: drive the reference's OWN restraint-generation subs
# (IF2dist_new, dist2rr, carr2tbl — chromosome3D.pl:110-206, 340-362) on a
# matrix file, producing oracle.dist / oracle.rr / oracle.tbl for byte-level
# comparison against chromosome3d's artifacts. The subs are extracted
# textually from the reference script (they are CNS-independent) and eval'd;
# nothing here reimplements their logic.
#
# Usage: perl perl_oracle.pl <chromosome3D.pl> <matrix.txt> <outdir> <K> <alpha> <sep>
use Carp;

my ($ref_script, $matrix, $outdir, $K, $alpha, $sep) = @ARGV;
die "usage: perl_oracle.pl ref.pl matrix.txt outdir K alpha sep\n"
    unless defined $sep;

open my $fh, '<', $ref_script or die "cannot read $ref_script: $!";
my $src = do { local $/; <$fh> };
close $fh;

# Extract one `sub NAME { ... }` by brace matching (the target subs contain
# no braces inside string literals, verified by inspection).
sub extract_sub {
    my ($name) = @_;
    my $i = index($src, "sub $name");
    die "sub $name not found in $ref_script\n" if $i < 0;
    my $j = index($src, '{', $i);
    my $depth = 0;
    my $k = $j;
    for (; $k < length($src); $k++) {
        my $c = substr($src, $k, 1);
        $depth++ if $c eq '{';
        if ($c eq '}') { $depth--; last if $depth == 0; }
    }
    return substr($src, $i, $k - $i + 1);
}

my $code = join "\n", map { extract_sub($_) }
    qw(IF2dist_new calc_len_IF dist2rr carr2tbl system_cmd count_lines
       print2file print2line);
eval $code;
die "eval of extracted subs failed: $@" if $@;

chdir $outdir or die "cannot chdir $outdir: $!";
# The subs read these as (package) globals once extracted from the script's
# lexical scope; set them exactly as main() would (chromosome3D.pl:18-20,61,65).
$L = calc_len_IF($matrix);
$ALPHA = $alpha;
$min_sep = $sep;

IF2dist_new($matrix, "oracle.dist", $K);
dist2rr("oracle.dist", "oracle.rr");
carr2tbl("oracle.rr", "oracle.tbl");
print "$L ", count_lines("oracle.tbl"), "\n";
