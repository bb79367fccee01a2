# Copied from cmtts_tpu/text/g2p.py (jax-free) so that the port imports nothing of cmtts_tpu.
"""Self-contained English grapheme-to-phoneme conversion.

The reference resolves words through ``lexicon/librispeech-lexicon.txt``
with a ``g2p_en`` fallback (``synthesize.py:168-192``); neither asset is
available in this environment, which previously made arbitrary-text
synthesis map every OOV word to ``spn``.  This module makes
``--mode single`` self-sufficient:

1. a curated exceptions lexicon (:data:`EXCEPTIONS`) of frequent English
   words with irregular spellings (function words, -ough words, loan
   words) carrying CMUdict-style stress marks;
2. context-sensitive letter-to-sound rules in the spirit of the classic
   public-domain NRL ruleset (Elovitz et al., 1976, "Automatic
   translation of English text to phonetics") — written from scratch for
   this repo, emitting the same ARPAbet inventory the symbol table uses
   (``cmtts_tpu/text/symbols.py``);
3. a first-syllable primary-stress heuristic for rule-derived words.

Output phones are valid ``@ARPAbet`` symbols, so
``text_to_sequence("{" + " ".join(phones) + "}")`` round-trips.
"""

from __future__ import annotations

import re

VOWELS = "aeiouy"
CONSONANTS = "bcdfghjklmnpqrstvwxz"
VOICED_CONS = "bdvgjlmnrwz"
FRONT = "eiy"
# letters whose word-final sound is voiceless (for -s / -ed voicing)
VOICELESS_END = "pkcfstx"

# ---------------------------------------------------------------------------
# Exceptions lexicon: common words whose spelling defies the rules.
# Pronunciations follow CMUdict (public domain).
# ---------------------------------------------------------------------------

_EXC_RAW = """
a AH0
an AE1 N
the DH AH0
of AH1 V
to T UW1
and AE1 N D
in IH0 N
is IH1 Z
was W AA1 Z
he HH IY1
she SH IY1
it IH1 T
his HH IH1 Z
her HH ER0
as AE1 Z
are AA1 R
they DH EY1
at AE1 T
be B IY1
this DH IH1 S
that DH AE1 T
these DH IY1 Z
those DH OW1 Z
than DH AE1 N
then DH EH1 N
them DH EH1 M
there DH EH1 R
their DH EH1 R
from F R AH1 M
or AO1 R
one W AH1 N
once W AH1 N S
had HH AE1 D
by B AY1
word W ER1 D
words W ER1 D Z
but B AH1 T
not N AA1 T
what W AH1 T
all AO1 L
were W ER1
we W IY1
when W EH1 N
your Y AO1 R
you Y UW1
said S EH1 D
says S EH1 Z
do D UW1
does D AH1 Z
done D AH1 N
how HH AW1
if IH1 F
will W IH1 L
up AH1 P
other AH1 DH ER0
about AH0 B AW1 T
out AW1 T
many M EH1 N IY0
any EH1 N IY0
has HH AE1 Z
have HH AE1 V
him HH IH1 M
who HH UW1
whom HH UW1 M
whose HH UW1 Z
been B IH1 N
now N AW1
my M AY1
me M IY1
i AY1
its IH1 T S
our AW1 ER0
two T UW1
too T UW1
very V EH1 R IY0
know N OW1
knows N OW1 Z
known N OW1 N
water W AO1 T ER0
first F ER1 S T
down D AW1 N
day D EY1
did D IH1 D
get G EH1 T
gets G EH1 T S
give G IH1 V
given G IH1 V AH0 N
gives G IH1 V Z
girl G ER1 L
go G OW1
goes G OW1 Z
gone G AO1 N
come K AH1 M
comes K AH1 M Z
some S AH1 M
something S AH1 M TH IH0 NG
could K UH1 D
would W UH1 D
should SH UH1 D
again AH0 G EH1 N
against AH0 G EH1 N S T
people P IY1 P AH0 L
only OW1 N L IY0
over OW1 V ER0
new N UW1
also AO1 L S OW0
years Y IH1 R Z
year Y IH1 R
work W ER1 K
works W ER1 K S
world W ER1 L D
because B IH0 K AO1 Z
through TH R UW1
though DH OW1
thought TH AO1 T
thorough TH ER1 OW0
enough IH0 N AH1 F
rough R AH1 F
tough T AH1 F
cough K AO1 F
laugh L AE1 F
laughter L AE1 F T ER0
bought B AO1 T
brought B R AO1 T
caught K AO1 T
daughter D AO1 T ER0
ought AO1 T
eight EY1 T
eighty EY1 T IY0
height HH AY1 T
weight W EY1 T
neighbor N EY1 B ER0
great G R EY1 T
break B R EY1 K
steak S T EY1 K
heart HH AA1 R T
hearth HH AA1 R TH
earth ER1 TH
early ER1 L IY0
learn L ER1 N
heard HH ER1 D
search S ER1 CH
friend F R EH1 N D
friends F R EH1 N D Z
again AH0 G EH1 N
any EH1 N IY0
busy B IH1 Z IY0
business B IH1 Z N AH0 S
woman W UH1 M AH0 N
women W IH1 M AH0 N
person P ER1 S AH0 N
pretty P R IH1 T IY0
iron AY1 ER0 N
island AY1 L AH0 N D
aisle AY1 L
answer AE1 N S ER0
often AO1 F AH0 N
listen L IH1 S AH0 N
castle K AE1 S AH0 L
whistle W IH1 S AH0 L
christmas K R IH1 S M AH0 S
half HH AE1 F
calf K AE1 F
talk T AO1 K
walk W AO1 K
walked W AO1 K T
walking W AO1 K IH0 NG
chalk CH AO1 K
folk F OW1 K
yolk Y OW1 K
salmon S AE1 M AH0 N
almond AA1 M AH0 N D
palm P AA1 M
calm K AA1 M
comb K OW1 M
tomb T UW1 M
womb W UW1 M
bomb B AA1 M
climb K L AY1 M
limb L IH1 M
lamb L AE1 M
thumb TH AH1 M
dumb D AH1 M
numb N AH1 M
crumb K R AH1 M
debt D EH1 T
doubt D AW1 T
subtle S AH1 T AH0 L
receipt R IH0 S IY1 T
two T UW1
sword S AO1 R D
one W AH1 N
own OW1 N
show SH OW1
shows SH OW1 Z
shown SH OW1 N
snow S N OW1
grow G R OW1
grown G R OW1 N
growth G R OW1 TH
throw TH R OW1
thrown TH R OW1 N
slow S L OW1
blow B L OW1
glow G L OW1
flow F L OW1
row R OW1
low L OW1
below B IH0 L OW1
window W IH1 N D OW0
yellow Y EH1 L OW0
follow F AA1 L OW0
tomorrow T AH0 M AA1 R OW0
borrow B AA1 R OW0
narrow N EH1 R OW0
arrow EH1 R OW0
shadow SH AE1 D OW0
pillow P IH1 L OW0
fellow F EH1 L OW0
elbow EH1 L B OW0
bowl B OW1 L
owner OW1 N ER0
most M OW1 S T
both B OW1 TH
don't D OW1 N T
won't W OW1 N T
can't K AE1 N T
didn't D IH1 D AH0 N T
doesn't D AH1 Z AH0 N T
isn't IH1 Z AH0 N T
wasn't W AA1 Z AH0 N T
weren't W ER1 N T
couldn't K UH1 D AH0 N T
wouldn't W UH1 D AH0 N T
shouldn't SH UH1 D AH0 N T
i'm AY1 M
i've AY1 V
i'll AY1 L
i'd AY1 D
you're Y UH1 R
you've Y UW1 V
you'll Y UW1 L
we're W IY1 R
we've W IY1 V
we'll W IY1 L
they're DH EH1 R
they've DH EY1 V
they'll DH EY1 L
he's HH IY1 Z
she's SH IY1 Z
it's IH1 T S
that's DH AE1 T S
there's DH EH1 R Z
here's HH IH1 R Z
what's W AH1 T S
let's L EH1 T S
put P UH1 T
puts P UH1 T S
push P UH1 SH
pull P UH1 L
full F UH1 L
bull B UH1 L
sugar SH UH1 G ER0
sure SH UH1 R
pleasure P L EH1 ZH ER0
measure M EH1 ZH ER0
treasure T R EH1 ZH ER0
usual Y UW1 ZH AH0 W AH0 L
usually Y UW1 ZH AH0 W AH0 L IY0
vision V IH1 ZH AH0 N
decision D IH0 S IH1 ZH AH0 N
television T EH1 L AH0 V IH2 ZH AH0 N
azure AE1 ZH ER0
genre ZH AA1 N R AH0
garage G ER0 AA1 ZH
machine M AH0 SH IY1 N
chef SH EH1 F
chicago SH IH0 K AA1 G OW0
choir K W AY1 ER0
chemistry K EH1 M AH0 S T R IY0
character K EH1 R IH0 K T ER0
chorus K AO1 R AH0 S
echo EH1 K OW0
school S K UW1 L
schedule S K EH1 JH UW0 L
stomach S T AH1 M AH0 K
ache EY1 K
anchor AE1 NG K ER0
orchestra AO1 R K AH0 S T R AH0
mechanic M AH0 K AE1 N IH0 K
technology T EH0 K N AA1 L AH0 JH IY0
heir EH1 R
honest AA1 N AH0 S T
honor AA1 N ER0
hour AW1 ER0
hours AW1 ER0 Z
ghost G OW1 S T
rhythm R IH1 DH AH0 M
rhyme R AY1 M
colonel K ER1 N AH0 L
lieutenant L UW0 T EH1 N AH0 N T
yacht Y AA1 T
suite S W IY1 T
queue K Y UW1
quay K IY1
gauge G EY1 JH
beauty B Y UW1 T IY0
beautiful B Y UW1 T AH0 F AH0 L
europe Y UH1 R AH0 P
eye AY1
eyes AY1 Z
buy B AY1
guy G AY1
dye D AY1
bye B AY1
goodbye G UH2 D B AY1
why W AY1
try T R AY1
tried T R AY1 D
tries T R AY1 Z
cry K R AY1
dry D R AY1
fly F L AY1
sky S K AY1
shy SH AY1
july JH UW0 L AY1
reply R IH0 P L AY1
supply S AH0 P L AY1
apply AH0 P L AY1
deny D IH0 N AY1
rely R IH0 L AY1
says S EH1 Z
said S EH1 D
again AH0 G EH1 N
against AH0 G EH1 N S T
mountain M AW1 N T AH0 N
fountain F AW1 N T AH0 N
captain K AE1 P T AH0 N
certain S ER1 T AH0 N
curtain K ER1 T AH0 N
britain B R IH1 T AH0 N
village V IH1 L AH0 JH
image IH1 M AH0 JH
damage D AE1 M AH0 JH
language L AE1 NG G W AH0 JH
courage K ER1 AH0 JH
average AE1 V R AH0 JH
message M EH1 S AH0 JH
marriage M EH1 R IH0 JH
carriage K AE1 R IH0 JH
college K AA1 L IH0 JH
knowledge N AA1 L AH0 JH
minute M IH1 N AH0 T
biscuit B IH1 S K AH0 T
circuit S ER1 K AH0 T
build B IH1 L D
built B IH1 L T
guide G AY1 D
guitar G IH0 T AA1 R
guest G EH1 S T
guess G EH1 S
tongue T AH1 NG
fatigue F AH0 T IY1 G
unique Y UW0 N IY1 K
antique AE0 N T IY1 K
technique T EH0 K N IY1 K
police P AH0 L IY1 S
ski S K IY1
pizza P IY1 T S AH0
piano P IY0 AE1 N OW0
radio R EY1 D IY0 OW0
studio S T UW1 D IY0 OW0
video V IH1 D IY0 OW0
idea AY0 D IY1 AH0
area EH1 R IY0 AH0
ocean OW1 SH AH0 N
soldier S OW1 L JH ER0
special S P EH1 SH AH0 L
social S OW1 SH AH0 L
ancient EY1 N CH AH0 N T
patient P EY1 SH AH0 N T
science S AY1 AH0 N S
scissors S IH1 Z ER0 Z
scene S IY1 N
scent S EH1 N T
muscle M AH1 S AH0 L
fascinate F AE1 S AH0 N EY2 T
discipline D IH1 S AH0 P L IH0 N
pseudo S UW1 D OW0
psychology S AY0 K AA1 L AH0 JH IY0
pneumonia N UW0 M OW1 N Y AH0
mortgage M AO1 R G AH0 JH
wednesday W EH1 N Z D EY2
february F EH1 B Y AH0 W EH2 R IY0
library L AY1 B R EH2 R IY0
literature L IH1 T ER0 AH0 CH ER0
temperature T EH1 M P R AH0 CH ER0
restaurant R EH1 S T ER0 AA2 N T
interesting IH1 N T R AH0 S T IH0 NG
different D IH1 F R AH0 N T
evening IY1 V N IH0 NG
every EH1 V ER0 IY0
everything EH1 V R IY0 TH IH2 NG
family F AE1 M AH0 L IY0
favorite F EY1 V ER0 IH0 T
separate S EH1 P ER0 EY2 T
chocolate CH AO1 K L AH0 T
vegetable V EH1 JH T AH0 B AH0 L
comfortable K AH1 M F ER0 T AH0 B AH0 L
camera K AE1 M ER0 AH0
several S EH1 V R AH0 L
desert D EH1 Z ER0 T
dessert D IH0 Z ER1 T
clothes K L OW1 DH Z
breakfast B R EH1 K F AH0 S T
meant M EH1 N T
dead D EH1 D
death D EH1 TH
bread B R EH1 D
breath B R EH1 TH
breathe B R IY1 DH
head HH EH1 D
heavy HH EH1 V IY0
health HH EH1 L TH
weather W EH1 DH ER0
feather F EH1 DH ER0
leather L EH1 DH ER0
instead IH0 N S T EH1 D
ready R EH1 D IY0
already AO0 L R EH1 D IY0
steady S T EH1 D IY0
spread S P R EH1 D
threat TH R EH1 T
sweat S W EH1 T
jealous JH EH1 L AH0 S
pleasant P L EH1 Z AH0 N T
peasant P EH1 Z AH0 N T
weapon W EH1 P AH0 N
heaven HH EH1 V AH0 N
sweater S W EH1 T ER0
ahead AH0 HH EH1 D
wear W EH1 R
bear B EH1 R
pear P EH1 R
tear T EH1 R
swear S W EH1 R
nothing N AH1 TH IH0 NG
mother M AH1 DH ER0
brother B R AH1 DH ER0
another AH0 N AH1 DH ER0
month M AH1 N TH
money M AH1 N IY0
monkey M AH1 NG K IY0
honey HH AH1 N IY0
onion AH1 N Y AH0 N
among AH0 M AH1 NG
none N AH1 N
nothing N AH1 TH IH0 NG
love L AH1 V
glove G L AH1 V
above AH0 B AH1 V
dove D AH1 V
oven AH1 V AH0 N
cover K AH1 V ER0
discover D IH0 S K AH1 V ER0
government G AH1 V ER0 M AH0 N T
color K AH1 L ER0
company K AH1 M P AH0 N IY0
country K AH1 N T R IY0
couple K AH1 P AH0 L
cousin K AH1 Z AH0 N
touch T AH1 CH
trouble T R AH1 B AH0 L
double D AH1 B AH0 L
young Y AH1 NG
southern S AH1 DH ER0 N
courtesy K ER1 T AH0 S IY0
journey JH ER1 N IY0
course K AO1 R S
court K AO1 R T
four F AO1 R
pour P AO1 R
your Y AO1 R
soul S OW1 L
shoulder SH OW1 L D ER0
boulder B OW1 L D ER0
soup S UW1 P
group G R UW1 P
through TH R UW1
wound W UW1 N D
youth Y UW1 TH
move M UW1 V
prove P R UW1 V
lose L UW1 Z
whose HH UW1 Z
shoe SH UW1
canoe K AH0 N UW1
do D UW1
into IH1 N T UW0
onto AA1 N T UW0
today T AH0 D EY1
tonight T AH0 N AY1 T
together T AH0 G EH1 DH ER0
orange AO1 R AH0 N JH
engine EH1 N JH AH0 N
magazine M AE1 G AH0 Z IY2 N
routine R UW0 T IY1 N
marine M ER0 IY1 N
ravine R AH0 V IY1 N
liter L IY1 T ER0
key K IY1
ballet B AE0 L EY1
buffet B AH0 F EY1
bouquet B UW0 K EY1
debris D AH0 B R IY1
corps K AO1 R
depot D IY1 P OW0
gourmet G UH0 R M EY1
cafe K AH0 F EY1
resume R IH0 Z UW1 M
naive N AY0 IY1 V
said S EH1 D
plaid P L AE1 D
many M EH1 N IY0
nine N AY1 N
ninth N AY1 N TH
twelve T W EH1 L V
live L IH1 V
lives L IH1 V Z
lived L IH1 V D
living L IH1 V IH0 NG
give G IH1 V
river R IH1 V ER0
liver L IH1 V ER0
deliver D IH0 L IH1 V ER0
olive AA1 L IH0 V
active AE1 K T IH0 V
native N EY1 T IH0 V
positive P AA1 Z AH0 T IH0 V
negative N EH1 G AH0 T IH0 V
relative R EH1 L AH0 T IH0 V
sensitive S EH1 N S AH0 T IH0 V
expensive IH0 K S P EH1 N S IH0 V
massive M AE1 S IH0 V
have HH AE1 V
love L AH1 V
some S AH1 M
none N AH1 N
gone G AO1 N
come K AH1 M
become B IH0 K AH1 M
welcome W EH1 L K AH0 M
handsome HH AE1 N S AH0 M
awesome AA1 S AH0 M
were W ER1
where W EH1 R
here HH IY1 R
there DH EH1 R
ore AO1 R
more M AO1 R
before B IH0 F AO1 R
store S T AO1 R
score S K AO1 R
shore SH AO1 R
wore W AO1 R
bore B AO1 R
core K AO1 R
tore T AO1 R
ignore IH0 G N AO1 R
explore IH0 K S P L AO1 R
therefore DH EH1 R F AO2 R
are AA1 R
bare B EH1 R
care K EH1 R
dare D EH1 R
fare F EH1 R
hare HH EH1 R
mare M EH1 R
rare R EH1 R
share SH EH1 R
spare S P EH1 R
square S K W EH1 R
stare S T EH1 R
scare S K EH1 R
aware AH0 W EH1 R
compare K AH0 M P EH1 R
declare D IH0 K L EH1 R
prepare P R IY0 P EH1 R
one W AH1 N
anyone EH1 N IY0 W AH2 N
everyone EH1 V R IY0 W AH2 N
someone S AH1 M W AH2 N
once W AH1 N S
only OW1 N L IY0
union Y UW1 N Y AH0 N
united Y UW0 N AY1 T AH0 D
university Y UW2 N AH0 V ER1 S AH0 T IY0
use Y UW1 S
used Y UW1 Z D
useful Y UW1 S F AH0 L
usual Y UW1 ZH AH0 W AH0 L
music M Y UW1 Z IH0 K
human HH Y UW1 M AH0 N
huge HH Y UW1 JH
future F Y UW1 CH ER0
beautiful B Y UW1 T AH0 F AH0 L
few F Y UW1
view V Y UW1
review R IY0 V Y UW1
interview IH1 N T ER0 V Y UW2
europe Y UH1 R AH0 P
cure K Y UH1 R
pure P Y UH1 R
during D UH1 R IH0 NG
secure S IH0 K Y UH1 R
mature M AH0 CH UH1 R
obvious AA1 B V IY0 AH0 S
serious S IH1 R IY0 AH0 S
various V EH1 R IY0 AH0 S
previous P R IY1 V IY0 AH0 S
curious K Y UH1 R IY0 AH0 S
period P IH1 R IY0 AH0 D
experience IH0 K S P IH1 R IY0 AH0 N S
material M AH0 T IH1 R IY0 AH0 L
interior IH0 N T IH1 R IY0 ER0
theory TH IY1 ER0 IY0
theater TH IY1 AH0 T ER0
real R IY1 L
really R IH1 L IY0
create K R IY0 EY1 T
reaction R IY0 AE1 K SH AH0 N
react R IY0 AE1 K T
english IH1 NG G L IH0 SH
england IH1 NG G L AH0 N D
pretty P R IH1 T IY0
women W IH1 M AH0 N
busy B IH1 Z IY0
minute M IH1 N AH0 T
lettuce L EH1 T AH0 S
framework F R EY1 M W ER2 K
somewhere S AH1 M W EH2 R
somewhat S AH1 M W AH2 T
homework HH OW1 M W ER2 K
network N EH1 T W ER2 K
"""

EXCEPTIONS: dict[str, list[str]] = {}
for _line in _EXC_RAW.strip().split("\n"):
    _parts = _line.split()
    EXCEPTIONS[_parts[0]] = _parts[1:]
del _EXC_RAW, _line, _parts


# ---------------------------------------------------------------------------
# Letter-to-sound rules.
#
# Each rule is (left_context, grapheme, right_context, phones).  Context
# pattern characters:
#   ' '  word boundary
#   '#'  one or more vowels               (a e i o u y)
#   ':'  zero or more consonants
#   '^'  exactly one consonant
#   '.'  one voiced consonant             (b d v g j l m n r w z)
#   '+'  one front vowel                  (e i y)
#   '%'  one of the suffixes e, es, ed, er, ely, ing
#   '~'  one letter that ends voiceless   (p k c f s t x)
#   else a literal letter
#
# Within a letter's list, rules are tried in order; first match wins.
# Phones are emitted without stress marks (stress is assigned after).
# ---------------------------------------------------------------------------

R = lambda l, g, r, p: (l, g, r, p.split())  # noqa: E731

RULES: dict[str, list] = {
    "a": [
        R("", "ability", "", "AH B IH L AH T IY"),
        R(" ", "ar", "o", "AH R"),
        R("", "air", "", "EH R"),
        R("", "augh", "", "AO"),
        R("#:", "ally", " ", "AH L IY"),
        R(" ", "al", "ly", "AO"),
        R("", "alk", "", "AO K"),
        R("", "all", "", "AO L"),
        R("", "al", "^", "AO L"),
        R(" :", "ation", "", "EY SH AH N"),
        R("", "aj", "", "EY JH"),  # major
        R("#:", "able", "", "AH B AH L"),
        R("", "ange", "", "EY N JH"),
        R("", "ation", "", "EY SH AH N"),
        R("", "aw", "", "AO"),
        R("", "au", "", "AO"),
        R(" ", "any", "", "EH N IY"),
        R("", "ai", "r", "EH"),
        R("", "ai", "", "EY"),
        R("", "ay", "", "EY"),
        R("", "arr", "", "AE R"),
        R("", "ar", "e ", "EH R"),
        R("", "ar", "e", "EH R"),  # parent, caring
        R("", "ar", "", "AA R"),
        R("", "a", "^le", "EY"),       # table, maple
        R("", "a", "^e ", "EY"),
        R("", "a", "^%", "EY"),   # making, maker, taken
        R("", "a", "^^", "AE"),
        R(" :", "a", " ", "AH"),
        R("", "a", " ", "AH"),
        R("", "a", "", "AE"),
    ],
    "b": [
        R("m", "b", " ", ""),          # silent: comb (mostly via exceptions)
        R("m", "b", "s ", ""),
        R("", "bb", "", "B"),
        R("", "b", "", "B"),
    ],
    "c": [
        R("", "ch", "r", "K"),         # chrome, christ
        R("s", "ch", "", "K"),         # school
        R("", "ch", "", "CH"),
        R("", "ck", "", "K"),
        R("", "cc", "+", "K S"),       # accept
        R("", "cc", "", "K"),
        R("", "cial", "", "SH AH L"),
        R("", "cious", "", "SH AH S"),
        R("", "cean", "", "SH AH N"),
        R("", "c", "+", "S"),
        R("", "c", "", "K"),
    ],
    "d": [
        R("", "dge", "", "JH"),
        R("", "dd", "", "D"),
        R("#:", "ded", " ", "D IH D"),
        R("", "d", "", "D"),
    ],
    "e": [
        R("t", "ed", " ", "IH D"),     # wanted
        R("d", "ed", " ", "IH D"),     # needed
        R("#:~", "ed", " ", "T"),      # jumped, walked
        R("#:^", "ed", " ", "D"),      # called, turned
        R("#", "ed", " ", "D"),        # played
        R("", "eigh", "", "EY"),
        R("", "ear", "", "IH R"),      # hear, near; (heart etc. in EXCEPTIONS)
        R("", "eer", "", "IH R"),
        R("", "ee", "", "IY"),
        R("", "ea", "", "IY"),
        R("", "ey", " ", "IY"),
        R("", "ew", "", "UW"),
        R("", "eu", "", "UW"),
        R("", "ei", "", "IY"),
        R("", "ere", " ", "IH R"),
        R("", "err", "", "EH R"),
        R("#:", "er", " ", "ER"),
        R("", "er", "", "ER"),
        R("^", "e", " ", ""),          # silent final e
        R("#:^", "es", " ", "Z"),      # plural after consonant: makes? no—
        R("", "e", "^e ", "IY"),       # theme, eve
        R("", "e", " ", "IY"),         # be, me (common ones in EXCEPTIONS)
        R("", "e", "d ", "EH"),        # red, bed (regular -ed via suffixes)
        R("", "e", "", "EH"),
    ],
    "f": [
        R("", "ff", "", "F"),
        R("", "f", "", "F"),
    ],
    "g": [
        R("", "gg", "", "G"),
        R(" ", "gn", "", "N"),         # gnome
        R("", "gn", " ", "N"),         # sign-like (mostly via 'ign')
        R("", "gh", "t", ""),          # light (via 'igh' too)
        R(" ", "gh", "", "G"),         # ghost
        R("#", "gh", "", ""),          # high, weigh
        R("", "ge", " ", "JH"),        # age, page
        R("", "g", "e%", "JH"),        # changed? (c-h)... cage->K EY JH
        R("", "g", "i", "JH"),         # giant, magic, engine
        R("", "g", "y", "JH"),         # energy
        R("", "g", "", "G"),           # get/give live in EXCEPTIONS
    ],
    "h": [
        R(" ", "h", "#", "HH"),
        R("#", "h", "", ""),           # oh, ah
        R("^", "h", "", ""),           # e.g. after consonant (rare)
        R("", "h", "", "HH"),
    ],
    "i": [
        R("", "igh", "", "AY"),
        R("", "ign", " ", "AY N"),
        R("", "ild", " ", "AY L D"),
        R("", "ind", " ", "AY N D"),
        R("", "ious", "", "IY AH S"),
        R("", "ier", "", "IY ER"),
        R("", "ie", " ", "AY"),        # tie, lie
        R("", "ied", " ", "AY D"),     # tried
        R("", "ies", " ", "IY Z"),     # cities
        R("", "ie", "", "IY"),         # field, believe
        R("", "irr", "", "IH R"),
        R("", "ir", "#", "AY R"),      # iron-like; (desire)
        R("", "ir", "", "ER"),         # bird, first
        R("", "ing", " ", "IH NG"),
        R("", "i", "^le", "AY"),       # title, rifle
        R("", "i", "^e ", "AY"),       # time, five
        R("", "i", "^%", "AY"),        # timing, writer
        R("", "i", "^^", "IH"),
        R(" :", "i", " ", "AY"),       # hi
        R("", "i", "o", "IY"),         # radio-like (most via 'tion' first)
        R("", "i", "", "IH"),
    ],
    "j": [
        R("", "j", "", "JH"),
    ],
    "k": [
        R(" ", "kn", "", "N"),         # know, knife
        R("", "kk", "", "K"),
        R("", "k", "", "K"),
    ],
    "l": [
        R("#:^", "le", " ", "AH L"),   # table, little
        R("#:^", "le", "s ", "AH L"),  # tables, candles
        R("", "ll", "", "L"),
        R("", "l", "", "L"),
    ],
    "m": [
        R("", "mm", "", "M"),
        R("", "mn", " ", "M"),         # autumn, column
        R("", "m", "", "M"),
    ],
    "n": [
        R("", "ng", "+", "N JH"),      # range-like (handled by 'ange' mostly)
        R("", "ngth", "", "NG TH"),    # strength
        R("", "ng", "r", "NG G"),
        R("", "ng", "l", "NG G"),      # single
        R("", "ng", "", "NG"),
        R("", "nk", "", "NG K"),
        R("", "nn", "", "N"),
        R("", "n", "", "N"),
    ],
    "o": [
        R("", "ough", "t", "AO"),      # (bought in EXCEPTIONS anyway)
        R("", "oast", "", "OW S T"),
        R("", "oo", "k", "UH"),
        R("", "ood", " ", "UH D"),     # good, wood (blood/food exceptions)
        R("", "oo", "", "UW"),
        R("", "oa", "", "OW"),
        R("", "oul", "d ", "UH"),      # could (in EXCEPTIONS)
        R("", "ought", "", "AO T"),
        R("", "ou", "s", "AH"),        # famous, nervous
        R("", "our", " ", "AO R"),     # (your/hour in EXCEPTIONS)
        R("", "ou", "", "AW"),         # out, house
        R("", "ow", " ", "OW"),        # know-type at end
        R("", "ow", "n ", "AW"),       # down, town (own/known in EXCEPTIONS)
        R("", "ow", "", "AW"),         # power, crowd
        R("", "oy", "", "OY"),
        R("", "oi", "", "OY"),
        R("", "org", "", "AO R G"),
        R("", "or", "", "AO R"),
        R("", "old", "", "OW L D"),
        R("", "oll", "", "OW L"),      # roll, toll
        R("", "olt", "", "OW L T"),
        R("", "o", "ng", "AO"),        # long, song
        R("", "o", "g ", "AO"),        # dog, log
        R("", "o", "gs ", "AO"),       # dogs, logs
        R("", "o", "ss", "AO"),        # loss, cross
        R("", "o", "st ", "AO"),       # cost, lost (most/both in EXCEPTIONS)
        R("", "o", "ff", "AO"),        # off, offer
        R("", "o", "^le", "OW"),       # noble
        R("", "o", "^e ", "OW"),       # home, bone
        R("", "o", "^%", "OW"),        # broken, hoping
        R("", "o", " ", "OW"),         # go, no
        R("", "o", "", "AA"),          # hot, top
    ],
    "p": [
        R(" ", "ps", "", "S"),         # psalm
        R(" ", "pn", "", "N"),
        R("", "ph", "", "F"),
        R("", "pp", "", "P"),
        R("", "p", "", "P"),
    ],
    "q": [
        R("", "qu", "", "K W"),
        R("", "q", "", "K"),
    ],
    "r": [
        R(" ", "rh", "", "R"),
        R("", "rr", "", "R"),
        R("", "r", "", "R"),
    ],
    "s": [
        R("", "ssion", "", "SH AH N"),
        R("", "sion", "", "ZH AH N"),
        R("", "sh", "", "SH"),
        R("", "ss", "", "S"),
        R("#", "sure", "", "ZH ER"),
        R("", "sch", "", "S K"),
        R("#", "s", "#", "Z"),         # intervocalic: music? (m-u-s-i: s
                                       # between vowels -> Z; "basic" too —
                                       # imperfect but the common case)
        R(".", "s", " ", "Z"),         # dogs, runs
        R("#", "s", " ", "Z"),         # days, goes
        R("e", "s", " ", "Z"),         # -es after silent e: makes? (k-e-s)..
        R("", "s", "", "S"),
    ],
    "t": [
        R(" ", "two", "", "T UW"),
        R("", "tch", "", "CH"),
        R("", "tion", "", "SH AH N"),
        R("", "tious", "", "SH AH S"),
        R("", "ture", "", "CH ER"),
        R("", "tual", "", "CH UW AH L"),
        R(" ", "th", "e ", "DH"),      # the (in EXCEPTIONS anyway)
        R("", "the", "r", "DH"),       # other, weather, father
        R("", "th", "", "TH"),
        R("", "tt", "", "T"),
        R("", "t", "", "T"),
    ],
    "u": [
        R(" ", "un", "i", "Y UW N"),   # university-like
        R(" ", "u", "^#", "Y UW"),     # unit-like? u + cons + vowel at start
        R("", "ur", "#", "UH R"),      # during-like
        R("", "urr", "", "ER"),
        R("", "ur", "", "ER"),         # turn, hurt
        R("", "ue", " ", "UW"),        # blue, true
        R("", "ui", "", "UW"),         # fruit, juice
        R("t", "u", "^e", "UW"),       # tune
        R("d", "u", "^e", "UW"),       # duke? (D UW K)
        R("l", "u", "^e", "UW"),       # flute
        R("r", "u", "^e", "UW"),       # rule
        R("s", "u", "^e", "UW"),       # (sure in EXCEPTIONS)
        R("j", "u", "^e", "UW"),       # june
        R("", "u", "^e ", "Y UW"),     # cube, use
        R("", "u", "^%", "Y UW"),      # computing
        R("", "u", "^^", "AH"),        # butter, number
        R("", "u", "", "AH"),          # but, cup
    ],
    "v": [
        R("", "v", "", "V"),
    ],
    "w": [
        R(" ", "wr", "", "R"),         # write
        R(" ", "wh", "o", "HH"),       # who (in EXCEPTIONS)
        R("", "wh", "", "W"),
        R("", "w", "", "W"),
    ],
    "x": [
        R(" ", "x", "", "Z"),          # xylophone
        R("", "x", "", "K S"),
    ],
    "y": [
        R(" ", "y", "#", "Y"),         # yes, you
        R("", "y", "^e ", "AY"),       # type, style
        R("", "y", "^%", "AY"),
        R("#:", "y", " ", "IY"),       # happy, city
        R("#:", "ys", " ", "IY Z"),
        R(" ^:", "y", " ", "AY"),      # my-type monosyllables (also EXCEPTIONS)
        R("", "y", " ", "IY"),
        R("", "y", "", "IH"),          # gym, system
    ],
    "z": [
        R("", "zz", "", "Z"),
        R("", "z", "", "Z"),
    ],
}
del R


def _is_vowel(c: str) -> bool:
    return c in VOWELS


def _match_left(text: str, pattern: str) -> bool:
    """Match ``pattern`` (read right-to-left) against the end of ``text``."""
    ti = len(text)
    for pc in reversed(pattern):
        if pc == ":":
            while ti > 0 and text[ti - 1] in CONSONANTS:
                ti -= 1
            continue
        if ti <= 0:
            return pc == " "
        c = text[ti - 1]
        if pc == " ":
            if c != " ":
                return False
        elif pc == "#":
            if not _is_vowel(c):
                return False
            while ti > 1 and _is_vowel(text[ti - 2]):
                ti -= 1
        elif pc == "^":
            if c not in CONSONANTS:
                return False
        elif pc == ".":
            if c not in VOICED_CONS:
                return False
        elif pc == "+":
            if c not in FRONT:
                return False
        elif pc == "~":
            if c not in VOICELESS_END:
                return False
        else:
            if c != pc:
                return False
        ti -= 1
    return True


_SUFFIXES = ("ely", "ing", "ed", "es", "er", "en", "e")


def _match_right(text: str, pattern: str) -> bool:
    """Match ``pattern`` against the start of ``text``."""
    ti = 0
    n = len(text)
    for pc in pattern:
        if pc == ":":
            while ti < n and text[ti] in CONSONANTS:
                ti += 1
            continue
        if pc == "%":
            for suf in _SUFFIXES:
                if text.startswith(suf, ti):
                    ti += len(suf)
                    break
            else:
                return False
            continue
        if ti >= n:
            return pc == " "
        c = text[ti]
        if pc == " ":
            if c != " ":
                return False
        elif pc == "#":
            if not _is_vowel(c):
                return False
            while ti + 1 < n and _is_vowel(text[ti + 1]):
                ti += 1
        elif pc == "^":
            if c not in CONSONANTS:
                return False
        elif pc == ".":
            if c not in VOICED_CONS:
                return False
        elif pc == "+":
            if c not in FRONT:
                return False
        elif pc == "~":
            if c not in VOICELESS_END:
                return False
        else:
            if c != pc:
                return False
        ti += 1
    return True


_VOWEL_PHONES = frozenset(
    "AA AE AH AO AW AY EH ER EY IH IY OW OY UH UW".split())


def _assign_stress(phones: list[str]) -> list[str]:
    """First vowel gets primary stress, the rest are unstressed — the
    dominant pattern for English content words; EXCEPTIONS entries carry
    their true stress."""
    out, stressed = [], False
    for p in phones:
        if p in _VOWEL_PHONES:
            out.append(p + ("0" if stressed else "1"))
            stressed = True
        else:
            out.append(p)
    return out


class RuleG2P:
    """Callable word -> ARPAbet phones (with stress digits)."""

    def __init__(self, extra_lexicon: dict[str, list[str]] | None = None):
        self.lexicon = dict(EXCEPTIONS)
        if extra_lexicon:
            self.lexicon.update(extra_lexicon)

    def _rules(self, word: str) -> list[str]:
        text = " " + word + " "
        phones: list[str] = []
        i = 1
        while i < len(text) - 1:
            c = text[i]
            matched = False
            for left, graph, right, ph in RULES.get(c, ()):
                if not text.startswith(graph, i):
                    continue
                if not _match_left(text[:i], left):
                    continue
                if not _match_right(text[i + len(graph):], right):
                    continue
                phones += ph
                i += len(graph)
                matched = True
                break
            if not matched:
                i += 1  # unpronounceable letter: skip
        return phones

    def __call__(self, word: str) -> list[str]:
        word = word.lower().strip()
        if not word:
            return []
        if word in self.lexicon:
            return list(self.lexicon[word])
        if not re.fullmatch(r"[a-z']+", word):
            # mixed alphanumerics: spell out what we can't rule-convert
            parts = re.findall(r"[a-z']+", word)
            out: list[str] = []
            for p in parts:
                out += self(p)
            return out
        # possessive / contraction tails not in EXCEPTIONS
        for tail, tail_word in (("'s", None), ("'ll", "will"),
                                ("'ve", "have"), ("'re", "are"),
                                ("'d", "would"), ("n't", "not")):
            if word.endswith(tail) and len(word) > len(tail):
                stem = self(word[: -len(tail)])
                if tail == "'s":
                    last = stem[-1] if stem else ""
                    base = last.rstrip("012")
                    if base in ("S", "Z", "SH", "ZH", "CH", "JH"):
                        return stem + ["IH0", "Z"]
                    voiceless = ("P", "T", "K", "F", "TH")
                    return stem + (["S"] if base in voiceless else ["Z"])
                return stem + self(tail_word)
        return _assign_stress(self._rules(word))


_DEFAULT: RuleG2P | None = None


def g2p(word: str) -> list[str]:
    """Module-level convenience wrapper around a shared :class:`RuleG2P`."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = RuleG2P()
    return _DEFAULT(word)
